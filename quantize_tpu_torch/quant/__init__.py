"""Quantization core: grids, fake-quant and observers."""
from .fakequant import dequantize_core, fake_quant, quantize_core
from .observers import MSE, MAMinMax, MinMax, build_observer
from .qspec import QuantSpec, broadcast_to_axis, compute_scale_zero, qrange

__all__ = [
    "MAMinMax", "MSE", "MinMax", "QuantSpec", "broadcast_to_axis", "build_observer",
    "compute_scale_zero", "dequantize_core", "fake_quant", "qrange",
    "quantize_core",
]
