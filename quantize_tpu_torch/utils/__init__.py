"""Config, logging, meters and registry helpers (copies of ``quantize_tpu.utils``; no JAX)."""
from .config import Config, get_cfg, parse_value, deep_merge, dict_merge, set_by_dotted_key
from .log import Logger, get_logger
from .meters import AverageMeter, MovingAverageMeter, accuracy, set_random_seed
from .registry import Registry, most_similar, edit_distance

__all__ = [
    "Config", "get_cfg", "parse_value", "deep_merge", "dict_merge", "set_by_dotted_key",
    "Logger", "get_logger",
    "AverageMeter", "MovingAverageMeter", "accuracy", "set_random_seed",
    "Registry", "most_similar", "edit_distance",
]
