"""Quantization-aware modules, config resolution and packed precision."""
from ..utils.registry import Registry
from .attention import QuantMultiheadAttention
from .intercept import QuantCtx
from .layers import (FP32, LayerQuantCfg, QuantConv, QuantDense, QuantGlobalAvgPool, QuantMaxPool,
                     QuantReLU)
from .precision import (fused_residual, packed_carry, packed_carry_dtype, packed_conv_barrier,
                        packed_fused_residual, packed_qin_carry, qin_carry,
                        set_packed_carry_dtype, set_packed_conv_barrier,
                        set_packed_fused_residual, set_packed_qin_carry)
from .qtensor import QTensor
from .quantizer import Quantizer, quantize_with_qparams, reset_observers

# the quant-module registry (JAX quantize_tpu/nn/__init__.py's names)
MODULES = Registry("quant modules")
MODULES.register_dict({
    "quantizer": Quantizer,
    "quantlinear": QuantDense,
    "quantconv2d": QuantConv,
    "quantrelu": QuantReLU,
    "quantmaxpool2d": QuantMaxPool,
    "quantadaptiveavgpool2d": QuantGlobalAvgPool,
    "quantmultiheadattention": QuantMultiheadAttention,
})

__all__ = [
    "FP32", "LayerQuantCfg", "MODULES", "QTensor", "QuantConv", "QuantCtx", "QuantDense",
    "QuantGlobalAvgPool", "QuantMaxPool", "QuantMultiheadAttention", "QuantReLU", "Quantizer",
    "fused_residual", "packed_carry", "packed_carry_dtype", "packed_conv_barrier",
    "packed_fused_residual", "packed_qin_carry", "qin_carry", "quantize_with_qparams",
    "reset_observers", "set_packed_carry_dtype", "set_packed_conv_barrier",
    "set_packed_fused_residual", "set_packed_qin_carry",
]
