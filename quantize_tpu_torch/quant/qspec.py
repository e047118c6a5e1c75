"""Static quantizer specifications and integer-grid helpers.

PyTorch counterpart of ``quantize_tpu/quant/qspec.py``; same convention:

* quantize:   ``q = clamp(round(x / scale - zero), qmin, qmax)``
* dequantize: ``x̂ = (q + zero) * scale * static_scale``

with integer grids:

* symmetric signed:    ``[-2^(b-1), 2^(b-1)-1]``, scale = absmax / (2^(b-1)-1)
* symmetric unsigned:  ``[0, 2^b-1]``,           scale = absmax / (2^b-1)
* asymmetric:          ``[0, 2^b-1]``, scale = (xmax-xmin)/(2^b-1), zero = xmin/scale
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch


def qrange(n_bits: int, symmetric: bool, signed: bool) -> Tuple[int, int]:
    """Integer grid (qmin, qmax) for a bit-width/symmetry/signedness combo."""
    if symmetric and signed:
        return -(1 << (n_bits - 1)), (1 << (n_bits - 1)) - 1
    return 0, (1 << n_bits) - 1


def quant_range_denominator(n_bits: int, symmetric: bool, signed: bool) -> float:
    """The divisor mapping the value range onto the integer grid.

    Symmetric-signed uses ``(qmax - qmin - 1)/2 = 2^(b-1)-1``; all other
    modes use ``qmax - qmin = 2^b - 1``.
    """
    qmin, qmax = qrange(n_bits, symmetric, signed)
    if symmetric and signed:
        return float(qmax - qmin - 1) / 2.0
    return float(qmax - qmin)


def compute_scale_zero(
    xmin: torch.Tensor,
    xmax: torch.Tensor,
    n_bits: int,
    symmetric: bool,
    signed: bool,
    eps: float = 1e-12,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map a value range to (scale, zero) per the reference convention.

    The divisor is a tensor, not a Python number: on CUDA PyTorch turns a
    division by a Python scalar into a multiplication by its float32
    reciprocal, one rounding away from the true quotient JAX computes.
    """
    if symmetric:
        value_range = torch.maximum(xmin.abs(), xmax.abs())
        denom = torch.full_like(value_range, quant_range_denominator(n_bits, symmetric, signed))
        scale = value_range / denom
        scale = torch.where(scale == 0, torch.full_like(scale, eps), scale)
        zero = torch.zeros_like(scale)
    else:
        value_range = xmax - xmin
        denom = torch.full_like(value_range, quant_range_denominator(n_bits, symmetric, signed))
        scale = value_range / denom
        scale = torch.where(scale == 0, torch.full_like(scale, eps), scale)
        zero = xmin / scale
    return scale, zero


_GRAN_ALIASES = {
    "l": "layer", "layer": "layer",
    "c": "channel", "channel": "channel",
}


def canon_granularity(granularity: str) -> str:
    key = str(granularity).lower()
    if key not in _GRAN_ALIASES:
        raise NotImplementedError(f"Granularity {granularity!r} not implemented")
    return _GRAN_ALIASES[key]


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static configuration of one quantizer (see ``quantize_tpu`` twin).

    ``channel_axis`` is the channel axis in the port's public layouts (NHWC
    activations and HWIO weights both use ``-1``).
    """

    n_bits: int = 8
    symmetric: bool = True
    signed: bool = True
    granularity: str = "layer"
    range: Mapping[str, Any] = dataclasses.field(default_factory=lambda: {"name": "maminmax"})
    adaround: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    flag: str = "weight"  # 'weight' | 'activation'
    channel_axis: int = -1

    def __post_init__(self):
        object.__setattr__(self, "granularity", canon_granularity(self.granularity))
        object.__setattr__(self, "range", _freeze(self.range))
        object.__setattr__(self, "adaround", _freeze(self.adaround))

    @property
    def enabled(self) -> bool:
        """n_bits >= 32 means pass-through."""
        return self.n_bits < 32

    @property
    def qmin(self) -> int:
        return qrange(self.n_bits, self.symmetric, self.signed)[0]

    @property
    def qmax(self) -> int:
        return qrange(self.n_bits, self.symmetric, self.signed)[1]

    @property
    def range_name(self) -> str:
        return str(dict(self.range).get("name", "maminmax")).lower()

    @property
    def range_kwargs(self) -> dict:
        kw = dict(self.range)
        kw.pop("name", None)
        return kw

    @property
    def per_channel(self) -> bool:
        return self.granularity == "channel"

    @property
    def storage_dtype(self) -> torch.dtype:
        """Narrowest native dtype able to hold the integer grid."""
        if self.n_bits <= 8:
            return torch.int8 if (self.symmetric and self.signed) else torch.uint8
        if self.n_bits <= 16:
            return torch.int16
        return torch.int32

    def n_channels(self, shape: Tuple[int, ...]) -> int:
        if not self.per_channel:
            return 1
        return shape[self.channel_axis]

    @classmethod
    def from_config(cls, cfg: Optional[Mapping], flag: str, channel_axis: int = -1) -> "QuantSpec":
        """Build from a config dict like the reference's w_setting/a_setting."""
        cfg = dict(cfg or {})
        cfg.pop("static_scale", None)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in known}
        kwargs["flag"] = flag
        kwargs["channel_axis"] = channel_axis
        return cls(**kwargs)


class _FrozenMap(tuple):
    """Hashable immutable mapping stored as sorted (k, v) tuples."""

    def __getitem__(self, key):
        if isinstance(key, str):
            for k, v in tuple.__iter__(self):
                if k == key:
                    return v
            raise KeyError(key)
        return tuple.__getitem__(self, key)

    def get(self, key, default=None):
        for k, v in self:
            if k == key:
                return v
        return default

    def __contains__(self, key):
        return any(k == key for k, _ in self)

    def keys(self):
        return [k for k, _ in self]

    def items(self):
        return list(self)


def _freeze(m: Any) -> Any:
    if isinstance(m, _FrozenMap):
        return m
    if isinstance(m, Mapping):
        return _FrozenMap(sorted((k, _freeze(v)) for k, v in m.items()))
    if isinstance(m, (list, tuple)):
        return tuple(_freeze(v) for v in m)
    return m


def broadcast_to_axis(v: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """Reshape a per-channel vector (C,) for broadcast along ``axis`` of an
    ndim-dimensional tensor. Scalars/size-1 vectors broadcast as-is."""
    v = torch.as_tensor(v)
    if v.ndim == 0 or v.numel() == 1:
        return v.reshape((1,) * ndim)
    shape = [1] * ndim
    shape[axis % ndim] = v.shape[0]
    return v.reshape(shape)
