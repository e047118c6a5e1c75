"""Quantized activation carrier for the packed inference path.

PyTorch counterpart of ``quantize_tpu/nn/qtensor.py``. :class:`QTensor`
holds an int8 activation with its per-tensor quantization parameters in the
shifted convention of the int8 kernels
(:func:`quantize_tpu_torch.ops.qmatmul.quantize_act_int8`):

    dequant(q) = (q + z_eff) * scale

With the int8 carry on (:func:`quantize_tpu_torch.nn.precision.qin_carry`),
residual blocks feed their skip and downsample branches from the main-path
conv's quantized input instead of the float tensor, so the skip path sees
``fake_quant(x)`` with that conv's activation parameters.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class QTensor:
    """int8 activation + per-tensor qparams (shifted zero convention)."""

    q: torch.Tensor  # int8
    scale: torch.Tensor  # f32 0-d
    z_eff: torch.Tensor  # f32 0-d; dequant = (q + z_eff) * scale

    def dequant(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Elementwise dequantize, as eager JAX orders it: cast, add the
        zero, multiply by the scale, cast to ``dtype``. Eager PyTorch fuses
        nothing here: the float tensor is written once, where XLA fuses the
        dequantize into its consumer."""
        out = (self.q.float() + self.z_eff) * self.scale
        return out.to(dtype)
