"""Quantization core: grids, fake-quant, observers and packing."""
from .fakequant import dequantize_core, fake_quant, quantize_core
from .observers import (ACIQ, AWQ, MSE, BiasCorrect, CrossEntropy, MAMinMax, MinMax,
                        build_observer)
from .pack import PackDescriptor, pack_int4_pairs, tpack, tunpack, unpack_int4_pairs
from .qspec import QuantSpec, broadcast_to_axis, compute_scale_zero, qrange

__all__ = [
    "ACIQ", "AWQ", "MSE", "BiasCorrect", "CrossEntropy", "MAMinMax", "MinMax",
    "PackDescriptor", "QuantSpec", "broadcast_to_axis", "build_observer", "compute_scale_zero",
    "dequantize_core", "fake_quant", "pack_int4_pairs", "qrange", "quantize_core", "tpack",
    "tunpack", "unpack_int4_pairs",
]
