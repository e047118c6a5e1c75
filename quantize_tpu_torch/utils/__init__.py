"""Config and registry helpers (copies of ``quantize_tpu.utils``; no JAX)."""
from .config import Config, dict_merge
from .registry import Registry

__all__ = ["Config", "Registry", "dict_merge"]
