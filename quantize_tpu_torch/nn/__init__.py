"""Quantization-aware modules, config resolution and packed precision."""
from .precision import (fused_residual, packed_carry, packed_carry_dtype, packed_conv_barrier,
                        packed_fused_residual, packed_qin_carry, qin_carry,
                        set_packed_carry_dtype, set_packed_conv_barrier,
                        set_packed_fused_residual, set_packed_qin_carry)
from .qtensor import QTensor

__all__ = [
    "QTensor", "fused_residual", "packed_carry", "packed_carry_dtype", "packed_conv_barrier",
    "packed_fused_residual", "packed_qin_carry", "qin_carry", "set_packed_carry_dtype",
    "set_packed_conv_barrier", "set_packed_fused_residual", "set_packed_qin_carry",
]
