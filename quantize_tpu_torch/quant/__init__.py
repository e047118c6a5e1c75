"""Quantization core: grids, fake-quant, observers, AdaRound and packing.

``set_quant_sim_dtype`` and ``quant_sim_dtype`` (the bf16 fake-quant
switch) import from here too; ``__all__`` lists JAX's names."""
from .adaround import adaround_round, beta_schedule, init_v, rect_sigmoid, regularization
from .fakequant import (dequantize_core, fake_quant, quant_sim_dtype, quantize_core, quantize_int,
                        set_quant_sim_dtype, ste_floor_plus, ste_round)
from .observers import (ACIQ, AWQ, MSE, RANGES, BiasCorrect, CrossEntropy, MAMinMax, MinMax,
                        build_observer, channel_view)
from .pack import PackDescriptor, pack_int4_pairs, tpack, tunpack, unpack_int4_pairs
from .qspec import (QuantSpec, broadcast_to_axis, canon_granularity, compute_scale_zero, qrange,
                    quant_range_denominator)

__all__ = [
    "QuantSpec", "qrange", "compute_scale_zero", "quant_range_denominator",
    "broadcast_to_axis", "canon_granularity",
    "ste_round", "ste_floor_plus", "quantize_core", "dequantize_core",
    "fake_quant", "quantize_int",
    "RANGES", "MinMax", "MAMinMax", "MSE", "CrossEntropy", "ACIQ", "AWQ",
    "BiasCorrect", "build_observer", "channel_view",
    "rect_sigmoid", "init_v", "regularization", "adaround_round", "beta_schedule",
    "PackDescriptor", "tpack", "tunpack", "pack_int4_pairs", "unpack_int4_pairs",
]
