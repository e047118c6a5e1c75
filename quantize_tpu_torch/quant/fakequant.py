"""Fake-quantization primitives with straight-through gradients.

PyTorch counterpart of ``quantize_tpu/quant/fakequant.py``. The JAX package
writes rounding as ``v + stop_gradient(round(v) - v)``; here the same
straight-through estimator is a ``torch.autograd.Function`` whose backward
passes the gradient unchanged. The clamp uses ``where`` with strict
inequalities, so an input exactly at qmin/qmax passes the full gradient,
like torch ``clamp`` and the JAX ``ste_clamp``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .qspec import broadcast_to_axis


class _RoundSTE(torch.autograd.Function):
    """Round half to even forward, identity gradient backward."""

    @staticmethod
    def forward(ctx, v):
        return torch.round(v)

    @staticmethod
    def backward(ctx, grad):
        return grad


def ste_round(v: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through (identity) gradient."""
    return _RoundSTE.apply(v)


def ste_clamp(q: torch.Tensor, qmin: float, qmax: float) -> torch.Tensor:
    """``clamp`` with gradient 1 inside the range including its endpoints."""
    hi = torch.full_like(q, float(qmax))
    lo = torch.full_like(q, float(qmin))
    return torch.where(q > qmax, hi, torch.where(q < qmin, lo, q))


def quantize_core(
    x: torch.Tensor,
    scale: torch.Tensor,
    zero: torch.Tensor,
    qmin: float,
    qmax: float,
    channel_axis: int = -1,
) -> torch.Tensor:
    """``clamp(round(x/scale - zero), qmin, qmax)`` (still float dtype)."""
    s = broadcast_to_axis(scale, x.ndim, channel_axis)
    z = broadcast_to_axis(zero, x.ndim, channel_axis)
    v = x / s - z
    return ste_clamp(ste_round(v), qmin, qmax)


def dequantize_core(
    q: torch.Tensor,
    scale: torch.Tensor,
    zero: torch.Tensor,
    channel_axis: int = -1,
    static_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(q + zero) * scale * static_scale``."""
    s = broadcast_to_axis(scale, q.ndim, channel_axis)
    z = broadcast_to_axis(zero, q.ndim, channel_axis)
    out = (q + z) * s
    if static_scale is not None:
        out = out * broadcast_to_axis(static_scale, q.ndim, channel_axis)
    return out


def fake_quant(
    x: torch.Tensor,
    scale: torch.Tensor,
    zero: torch.Tensor,
    qmin: float,
    qmax: float,
    channel_axis: int = -1,
    static_scale: Optional[torch.Tensor] = None,
    awq_scale: Optional[torch.Tensor] = None,
    awq_axis: int = -2,
) -> torch.Tensor:
    """Simulated quantization: quantize then dequantize. With ``awq_scale``
    the input is pre-scaled along ``awq_axis`` (the in-channel axis) before
    quantization and divided back afterwards."""
    if awq_scale is not None:
        aws = broadcast_to_axis(awq_scale, x.ndim, awq_axis)
        x = x * aws
    q = quantize_core(x, scale, zero, qmin, qmax, channel_axis)
    out = dequantize_core(q, scale, zero, channel_axis, static_scale)
    return out if awq_scale is None else out / aws

