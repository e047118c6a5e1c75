"""Int4 lane packing: two signed int4 values in one int8 along an axis.

A copy of ``pack_int4_pairs`` / ``unpack_int4_pairs`` of
``quantize_tpu/quant/pack.py:106-131``: the layout of a packed int4 conv
weight (``packed/w_p4c``, pairs along the kernel's input-channel axis), so
that the port loads and writes the JAX package's bytes as they are. The
dense ``tpack``/``tunpack`` stream packing is not ported yet (ROADMAP.md
queue 1 item 7).
"""
from __future__ import annotations

import torch


def pack_int4_pairs(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack signed int4 values pairwise into int8 along ``axis``: element
    ``2i`` in the low nibble, ``2i + 1`` in the high one. The axis length
    must be even."""
    q = q.to(torch.int8)
    axis = axis % q.ndim
    if q.shape[axis] % 2:
        raise ValueError(f"axis {axis} length {q.shape[axis]} must be even for int4 packing")
    even = q.index_select(axis, torch.arange(0, q.shape[axis], 2, device=q.device))
    odd = q.index_select(axis, torch.arange(1, q.shape[axis], 2, device=q.device))
    return (even & 0x0F) | (odd.to(torch.uint8) << 4).to(torch.int8)


def unpack_int4_pairs(p: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Unpack int8 nibble pairs back to signed int4 values (as int8)."""
    p = p.to(torch.int8)
    axis = axis % p.ndim
    even = (p << 4) >> 4  # sign-extend the low nibble (arithmetic shift)
    odd = p >> 4
    shape = list(p.shape)
    shape[axis] *= 2
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)
