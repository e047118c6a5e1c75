"""Calibration range observers as ``(state, x) -> (state, scale, zero)``.

PyTorch counterpart of ``quantize_tpu/quant/observers.py``. Only the
accumulating ``minmax`` observer (with its ``percentile`` clipping) is
ported so far; :func:`build_observer` raises for every other name the JAX
package registers.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..utils.registry import Registry
from .qspec import QuantSpec, compute_scale_zero

RANGES = Registry("range observers")

State = Dict[str, torch.Tensor]

# observers the JAX package has and the port does not have yet
_NOT_PORTED = ("maminmax", "mse", "cross_entropy", "aciq", "awq", "bias_correct")


def channel_view(x: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Reshape to (C, M): channel axis first, everything else flattened."""
    x = torch.movedim(x, channel_axis, 0)
    return x.reshape(x.shape[0], -1)


def _kth_smallest(rows: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest (1-indexed) along the last axis of a (C, M) array."""
    k = max(min(k, rows.shape[-1]), 1)
    return torch.sort(rows, dim=-1).values[..., k - 1]


class MinMax:
    """Accumulating min/max observer.

    ``percentile > 0`` clips the range to the percentile-th order statistics.
    """

    name = "minmax"

    def __init__(self, spec: QuantSpec, percentile: float = 0.0, **_):
        self.spec = spec
        self.percentile = float(percentile)

    def init_state(self, n_channels: int, device=None) -> State:
        return {
            "xmin": torch.zeros((n_channels,), dtype=torch.float32, device=device),
            "xmax": torch.zeros((n_channels,), dtype=torch.float32, device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def _update(self, state: State, xmin: torch.Tensor, xmax: torch.Tensor) -> State:
        seen = state["count"] > 0
        return {
            "xmin": torch.where(seen, torch.minimum(state["xmin"], xmin), xmin),
            "xmax": torch.where(seen, torch.maximum(state["xmax"], xmax), xmax),
            "count": state["count"] + 1,
        }

    def batch_range(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Current-batch (xmin, xmax), shaped (C,) ((1,) for layer gran)."""
        spec = self.spec
        flat = channel_view(x, spec.channel_axis) if spec.per_channel else x.reshape(1, -1)
        n = flat.shape[-1]
        if spec.symmetric:
            xmin = torch.zeros((flat.shape[0],), dtype=x.dtype, device=x.device)
            if self.percentile == 0.0:
                xmax = flat.abs().amax(dim=-1)
            else:
                xmax = _kth_smallest(flat.abs(), int(n * (1 - self.percentile)))
        else:
            if self.percentile == 0.0:
                xmin = flat.amin(dim=-1)
                xmax = flat.amax(dim=-1)
            else:
                xmin = _kth_smallest(flat, int(n * self.percentile) + 1)
                xmax = _kth_smallest(flat, int(n * (1 - self.percentile)))
        return xmin.float(), xmax.float()

    def range(self, state: State, x: torch.Tensor) -> Tuple[State, torch.Tensor, torch.Tensor]:
        xmin, xmax = self.batch_range(x)
        state = self._update(state, xmin, xmax)
        return state, state["xmin"], state["xmax"]

    def quantize(self, xmin: torch.Tensor, xmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return compute_scale_zero(
            xmin, xmax, self.spec.n_bits, self.spec.symmetric, self.spec.signed
        )

    def __call__(self, state: State, x: torch.Tensor, **_) -> Tuple[State, torch.Tensor, torch.Tensor]:
        state, xmin, xmax = self.range(state, x)
        scale, zero = self.quantize(xmin, xmax)
        return state, scale, zero


RANGES.register_dict({"minmax": MinMax})


def build_observer(spec: QuantSpec) -> MinMax:
    """Instantiate the observer named in ``spec.range``."""
    name = spec.range_name
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"observer {name!r} is not ported to quantize_tpu_torch yet "
            "(only 'minmax'); see ROADMAP.md")
    cls = RANGES.lookup(name)
    return cls(spec, **spec.range_kwargs)
