"""LayerNorm with the fused kernel path for packed inference.

PyTorch counterpart of ``quantize_tpu/nn/norm.py``: parameters ``scale``
and ``bias`` under the flax names, float32 statistics in every mode, and
kernel K6 (:func:`~quantize_tpu_torch.ops.layernorm.layernorm`) in packed
mode. ``params_tuple()`` hands the raw tensors to a consumer layer that
fuses the normalize into its activation quantize (kernel K7).
"""
from __future__ import annotations

import torch

from ..ops.layernorm import _ln_math, layernorm
from .precision import packed_carry_dtype
from .variables import VarModule


class FusedLayerNorm(VarModule):
    def __init__(self, features: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.put_var("params", "scale", torch.ones((features,), dtype=torch.float32, device=device))
        self.put_var("params", "bias", torch.zeros((features,), dtype=torch.float32, device=device))

    def init_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.get_var("params", "scale").fill_(1.0)
            self.get_var("params", "bias").zero_()

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        scale, bias = self.get_var("params", "scale"), self.get_var("params", "bias")
        if mode == "packed":
            # the output in the carry dtype, as the model's float glue ops
            return layernorm(x, scale, bias, self.epsilon, out_dtype=packed_carry_dtype())
        y = _ln_math(x.float(), scale.float(), bias.float(), self.epsilon)
        return y.to(x.dtype)

    def params_tuple(self):
        """(scale, bias, eps) for consumers that fuse the LayerNorm into
        their own quantize (``QuantDense``/``QuantMultiheadAttention``
        ``pre_norm``)."""
        return self.get_var("params", "scale"), self.get_var("params", "bias"), self.epsilon
