"""quantize_tpu_torch — the PyTorch / CUDA port of ``quantize_tpu``.

The port runs the JAX package's serving paths on an NVIDIA H100: build
-> init (one calibrate pass) -> calibration -> pack -> packed forward
through hand-written int8 tensor-core kernels (``csrc/*.cu``, built with
nvcc at first use); and its PTQ, QAT and AdaRound runners from a YAML
config (:func:`execute_runner`, ``python -m quantize_tpu_torch.cli``); and it
exports the packed forward through ``torch.export`` (:func:`export_forward`,
:func:`load_exported`, :func:`export_mlir_text`). It imports
no JAX and nothing of ``quantize_tpu``. Entry points run on CUDA unless the
caller passes ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version. Packed inference spreads over the ranks of a ``(data,
model)`` mesh (:func:`make_mesh`, :func:`shard_variables`), one process a
rank over ``torch.distributed`` on gloo, and :func:`measure_scaling` times
it against one device.
"""
from .api import calibrate_model, init_model
from .deploy import model_size_bytes, pack_model, unpack_model
from .export import export_forward, export_mlir_text, load_exported
from .models import MODELS
from .nn.intercept import QuantCtx
from .nn.layers import LayerQuantCfg, QuantConv, QuantDense
from .nn.precision import (fused_residual, packed_carry, qin_carry, set_packed_carry_dtype,
                           set_packed_conv_barrier, set_packed_fused_residual,
                           set_packed_qin_carry)
from .nn.qtensor import QTensor
from .nn.quantizer import reset_observers
from .parallel import make_mesh, measure_scaling, shard_variables
from .runners import execute_runner
from .utils import Config

__version__ = "0.2.0"

__all__ = [
    "Config", "LayerQuantCfg", "MODELS", "QTensor", "QuantConv", "QuantCtx", "QuantDense",
    "calibrate_model", "execute_runner", "export_forward", "export_mlir_text",
    "fused_residual", "init_model", "load_exported", "make_mesh", "measure_scaling",
    "model_size_bytes", "pack_model", "packed_carry", "qin_carry", "reset_observers",
    "set_packed_carry_dtype", "set_packed_conv_barrier", "set_packed_fused_residual",
    "set_packed_qin_carry", "shard_variables", "unpack_model",
]
