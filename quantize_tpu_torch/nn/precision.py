"""Deploy-time carry precision and the fused residual tail switch.

PyTorch counterpart of ``quantize_tpu/nn/precision.py``, with the same names
and defaults: packed layers cast their outputs to the carry dtype (float32
unless set), and the fused 1x1-conv + residual + ReLU tail is off unless
:func:`set_packed_fused_residual` turns it on.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any

import torch

_CARRY_DTYPE: torch.dtype = torch.float32
_FUSED_RESIDUAL: bool = False


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


def _as_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(getattr(dtype, "name", dtype))
    table = {"float32": torch.float32, "f32": torch.float32,
             "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unsupported carry dtype {dtype!r}")
    return table[name]
