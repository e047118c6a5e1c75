"""LayerNorms: the fused kernel path for packed inference, and flax's own.

:class:`FusedLayerNorm` is the PyTorch counterpart of
``quantize_tpu/nn/norm.py``: parameters ``scale`` and ``bias`` under the
flax names, float32 statistics in every mode, and kernel K6
(:func:`~quantize_tpu_torch.ops.layernorm.layernorm`) in packed mode.
``params_tuple()`` hands the raw tensors to a consumer layer that fuses the
normalize into its activation quantize (kernel K7).

:class:`LayerNorm` is ``flax.linen.LayerNorm`` (CLIP's ``ln_pre``,
``ln_post`` and ``ln_final``): no kernel in any mode, flax's order of
operations.
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


class LayerNorm(FusedLayerNorm):
    """``flax.linen.LayerNorm`` over the last axis (FusedLayerNorm's
    parameters, none of its kernels), in flax's order of operations
    (``flax/linen/normalization.py``, 0.12): statistics in at least float32,
    the "fast" variance ``max(0, mean(x^2) - mean(x)^2)``, then ``(x - mean)
    * (rsqrt(var + eps) * scale) + bias``. The means are sums divided by a
    float32 tensor (on CUDA PyTorch turns a division by a Python scalar, and
    ``Tensor.mean``, into a multiplication by the reciprocal). The output
    takes the promoted dtype of ``x`` and the float32 parameters, as flax's
    does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = self.get_var("params", "scale"), self.get_var("params", "bias")
        x32 = x.float()
        n = torch.tensor(float(x.shape[-1]), dtype=torch.float32, device=x.device)
        mu = x32.sum(dim=-1, keepdim=True) / n
        mu2 = (x32 * x32).sum(dim=-1, keepdim=True) / n
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.epsilon) * scale)
        return (y + bias).to(torch.promote_types(x.dtype, torch.float32))
