"""Deploy-time carry precision, the fused residual tail and the int8 carry.

PyTorch counterpart of ``quantize_tpu/nn/precision.py``, with the same names
and defaults: packed layers cast their outputs to the carry dtype (float32
unless set); the fused 1x1-conv + residual + ReLU tail is off unless
:func:`set_packed_fused_residual` turns it on; residual blocks carry floats
between blocks unless :func:`qin_carry` turns on the int8 carry.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any

import torch

_CARRY_DTYPE: torch.dtype = torch.float32
_FUSED_RESIDUAL: bool = False
_QIN_CARRY: bool = False
_CONV_BARRIER: bool = False


def set_packed_carry_dtype(dtype: Any) -> None:
    """Set the dtype packed layers cast their outputs to."""
    global _CARRY_DTYPE
    _CARRY_DTYPE = torch.float32 if dtype is None else _as_dtype(dtype)


def packed_carry_dtype() -> torch.dtype:
    return _CARRY_DTYPE


@contextmanager
def packed_carry(dtype: Any):
    prev = _CARRY_DTYPE
    set_packed_carry_dtype(dtype)
    try:
        yield
    finally:
        set_packed_carry_dtype(prev)


def set_packed_fused_residual(enabled: bool) -> None:
    """Route packed bottleneck tails (conv3 + skip add + ReLU) through the
    fused kernel :func:`quantize_tpu_torch.ops.qconv1x1.conv1x1_residual`
    wherever its structural conditions hold."""
    global _FUSED_RESIDUAL
    _FUSED_RESIDUAL = bool(enabled)


def packed_fused_residual() -> bool:
    return _FUSED_RESIDUAL


@contextmanager
def fused_residual(enabled: bool = True):
    prev = _FUSED_RESIDUAL
    set_packed_fused_residual(enabled)
    try:
        yield
    finally:
        set_packed_fused_residual(prev)


def set_packed_qin_carry(enabled: bool) -> None:
    """Enable int8 quantized-domain carries across residual blocks: packed
    residual blocks feed their skip/downsample branches from the main-path
    conv's quantized input (:class:`~.qtensor.QTensor`) rather than the
    float activation, so the skip path sees ``fake_quant(x)``."""
    global _QIN_CARRY
    _QIN_CARRY = bool(enabled)


def packed_qin_carry() -> bool:
    return _QIN_CARRY


@contextmanager
def qin_carry(enabled: bool = True):
    prev = _QIN_CARRY
    set_packed_qin_carry(enabled)
    try:
        yield
    finally:
        set_packed_qin_carry(prev)


def set_packed_conv_barrier(enabled: bool) -> None:
    """JAX's switch that materializes each packed conv's int8 activation
    (``lax.optimization_barrier``) so that XLA cannot fuse its producer
    chain into the conv. A flag with no effect here: in eager PyTorch each
    int8 activation is already written out by its quantize before the conv
    kernel reads it."""
    global _CONV_BARRIER
    _CONV_BARRIER = bool(enabled)


def packed_conv_barrier() -> bool:
    return _CONV_BARRIER


def _as_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(getattr(dtype, "name", dtype))
    table = {"float32": torch.float32, "f32": torch.float32,
             "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported carry dtype {dtype!r}")
    return table[name]
