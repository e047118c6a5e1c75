"""Integer packing: dense sub-byte streams and int4 lane pairs.

PyTorch counterpart of ``quantize_tpu/quant/pack.py``, in two parts:

1. **Dense stream packing** (:func:`tpack` / :func:`tunpack`): 1..8-bit
   integers packed with no wasted bits into a flat ``uint8`` buffer. Each
   element gives its ``b`` bits LSB first to a bit stream in element order,
   and the stream is cut into bytes LSB first. Signed values are offset by
   ``+2^(b-1)`` before packing. A :class:`PackDescriptor` carries
   ``(n_bits, signed, shape)``. The bytes are the JAX package's, so each
   package unpacks the other's buffers; :mod:`quantize_tpu_torch.engine`
   holds a native host packer of the same layout.
2. **Int4 lane pairs** (:func:`pack_int4_pairs` / :func:`unpack_int4_pairs`):
   two signed int4 values in one int8 along an axis, the layout of a packed
   int4 conv weight (``packed/w_p4c``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PackDescriptor:
    """Metadata needed to invert :func:`tpack`."""

    n_bits: int
    signed: bool
    shape: Tuple[int, ...]

    def to_json(self) -> str:
        return json.dumps({"n_bits": self.n_bits, "signed": self.signed, "shape": list(self.shape)})

    @classmethod
    def from_json(cls, s: str) -> "PackDescriptor":
        d = json.loads(s)
        return cls(int(d["n_bits"]), bool(d["signed"]), tuple(d["shape"]))


def grid(n_bits: int, signed: bool) -> Tuple[int, int]:
    """The integer range ``[lo, hi]`` of an ``n_bits`` grid."""
    if not 1 <= n_bits <= 8:
        raise ValueError(f"tpack supports 1..8 bits, got {n_bits}")
    return (-(1 << (n_bits - 1)), (1 << (n_bits - 1)) - 1) if signed else (0, (1 << n_bits) - 1)


def tpack(x, n_bits: int, signed: bool) -> Tuple[torch.Tensor, PackDescriptor]:
    """Pack an integer-valued tensor (or array) into a dense uint8 bit stream
    of ``ceil(n * b / 8)`` bytes, on the tensor's device. Values are rounded
    half to even in float32, then clamped to the grid, as the JAX package
    does."""
    lo, hi = grid(n_bits, signed)
    v = torch.as_tensor(x)
    des = PackDescriptor(n_bits, signed, tuple(v.shape))
    v = torch.clamp(torch.round(v.to(torch.float32)), lo, hi).to(torch.int32)
    if signed:
        v = v + (1 << (n_bits - 1))
    u = v.to(torch.uint8).reshape(-1)
    shifts = torch.arange(n_bits, dtype=torch.uint8, device=u.device)
    stream = ((u[:, None] >> shifts) & 1).reshape(-1)  # (N, b) bit planes, LSB first
    stream = torch.nn.functional.pad(stream, (0, -stream.numel() % 8))
    weights = torch.arange(8, dtype=torch.uint8, device=u.device)
    packed = (stream.reshape(-1, 8) << weights).sum(-1, dtype=torch.int32).to(torch.uint8)
    return packed, des


def tunpack(packed, des: PackDescriptor, dtype=torch.float32) -> torch.Tensor:
    """Invert :func:`tpack`, restoring the shape and signedness."""
    packed = torch.as_tensor(packed)
    n_bits = des.n_bits
    n = 1
    for d in des.shape:
        n *= int(d)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    stream = ((packed[:, None] >> shifts) & 1).reshape(-1)[: n * n_bits]
    planes = stream.reshape(n, n_bits).to(torch.int32)
    u = (planes << torch.arange(n_bits, dtype=torch.int32, device=packed.device)).sum(-1)
    if des.signed:
        u = u - (1 << (n_bits - 1))
    return u.reshape(des.shape).to(dtype)


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
