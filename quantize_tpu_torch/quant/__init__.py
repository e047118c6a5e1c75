"""Quantization core: grids, fake-quant and observers."""
from .fakequant import dequantize_core, fake_quant, quantize_core
from .observers import (ACIQ, AWQ, MSE, BiasCorrect, CrossEntropy, MAMinMax, MinMax,
                        build_observer)
from .qspec import QuantSpec, broadcast_to_axis, compute_scale_zero, qrange

__all__ = [
    "ACIQ", "AWQ", "BiasCorrect", "CrossEntropy", "MAMinMax", "MSE", "MinMax", "QuantSpec",
    "broadcast_to_axis", "build_observer", "compute_scale_zero", "dequantize_core",
    "fake_quant", "qrange", "quantize_core",
]
