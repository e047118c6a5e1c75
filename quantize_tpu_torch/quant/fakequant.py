"""Fake-quantization primitives with straight-through gradients.

PyTorch counterpart of ``quantize_tpu/quant/fakequant.py``. The JAX package
writes rounding as ``v + stop_gradient(round(v) - v)``; here the same
straight-through estimator is a ``torch.autograd.Function`` whose backward
passes the gradient unchanged. The clamp uses ``where`` with strict
inequalities, so an input exactly at qmin/qmax passes the full gradient,
like torch ``clamp`` and the JAX ``ste_clamp``. AdaRound's rounding
(``ste_floor_plus``) comes in through the ``round_fn`` argument of
:func:`quantize_core` and :func:`fake_quant`.

:func:`set_quant_sim_dtype` (JAX's switch) runs :func:`fake_quant`'s
divide/round/clamp/dequant chain in bfloat16, each op rounded to bfloat16
as eager JAX rounds it, for a float32 input without AdaRound rounding or
an AWQ scale; the deploy quantize (:func:`quantize_int`) is not affected.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .qspec import QuantSpec, broadcast_to_axis


_SIM_DTYPE: Optional[torch.dtype] = None  # None: fake quant in the input's dtype


def set_quant_sim_dtype(dtype) -> None:
    """Select the fake-quant arithmetic dtype of simulation and QAT
    forwards: ``"bfloat16"`` (or ``torch.bfloat16``) runs the chain in
    bf16; None, ``"float32"`` or ``"f32"`` (or ``torch.float32``) restores
    the exact float32 chain (the default)."""
    global _SIM_DTYPE
    if dtype in (None, "float32", "f32", torch.float32):
        _SIM_DTYPE = None
    else:
        _SIM_DTYPE = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))


def quant_sim_dtype() -> Optional[torch.dtype]:
    """The dtype :func:`set_quant_sim_dtype` selected, or None."""
    return _SIM_DTYPE


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


def ste_floor_plus(v: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """AdaRound's rounding ``round(floor(v) + frac)``: the gradient reaches
    only ``frac`` (``floor`` passes none), and the hard rounding is
    straight-through."""
    return ste_round(torch.floor(v).detach() + frac)


def quantize_core(
    x: torch.Tensor,
    scale: torch.Tensor,
    zero: torch.Tensor,
    qmin: float,
    qmax: float,
    channel_axis: int = -1,
    round_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """``clamp(round_fn(x/scale - zero), qmin, qmax)`` (still float dtype)."""
    s = broadcast_to_axis(scale, x.ndim, channel_axis)
    z = broadcast_to_axis(zero, x.ndim, channel_axis)
    v = x / s - z
    return ste_clamp((round_fn or ste_round)(v), qmin, qmax)


def quantize_int(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 spec: QuantSpec) -> torch.Tensor:
    """Quantize to the narrow integer storage dtype (the packed path), with
    no gradient."""
    q = quantize_core(x, scale, zero, spec.qmin, spec.qmax, spec.channel_axis)
    return q.detach().to(spec.storage_dtype)


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
    round_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Simulated quantization: quantize then dequantize. With ``awq_scale``
    the input is pre-scaled along ``awq_axis`` (the in-channel axis) before
    quantization and divided back afterwards. Under
    :func:`set_quant_sim_dtype` a float32 ``x`` with neither ``round_fn`` nor
    ``awq_scale`` is cast in, run through the chain narrow and cast back
    (the casts of scale and zero keep their gradients)."""
    sd = _SIM_DTYPE
    if sd is not None and x.dtype == torch.float32 and round_fn is None and awq_scale is None:
        out = fake_quant(x.to(sd), scale.to(sd), zero.to(sd), qmin, qmax, channel_axis,
                         None if static_scale is None else static_scale.to(sd))
        return out.to(x.dtype)
    if awq_scale is not None:
        aws = broadcast_to_axis(awq_scale, x.ndim, awq_axis)
        x = x * aws
    q = quantize_core(x, scale, zero, qmin, qmax, channel_axis, round_fn)
    out = dequantize_core(q, scale, zero, channel_axis, static_scale)
    return out if awq_scale is None else out / aws

