"""Calibration range observers as ``(state, x) -> (state, scale, zero)``.

PyTorch counterpart of ``quantize_tpu/quant/observers.py``. Ported so far:
the accumulating ``minmax`` observer (with its ``percentile`` clipping),
the moving-average ``maminmax`` and the ``mse`` grid search;
:func:`build_observer` raises for every other name the JAX package
registers.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..utils.registry import Registry
from .fakequant import fake_quant
from .qspec import QuantSpec, compute_scale_zero

RANGES = Registry("range observers")

State = Dict[str, torch.Tensor]

# observers the JAX package has and the port does not have yet
_NOT_PORTED = ("cross_entropy", "aciq", "awq", "bias_correct")


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


class MAMinMax(MinMax):
    """Moving-average min/max: EMA when momentum is in [0, 1], else accumulate."""

    name = "maminmax"

    def __init__(self, spec: QuantSpec, percentile: float = 0.0, momentum: float = 0.1, **_):
        super().__init__(spec, percentile)
        self.momentum = float(momentum)

    def _update(self, state: State, xmin: torch.Tensor, xmax: torch.Tensor) -> State:
        if not (0.0 <= self.momentum <= 1.0):
            return super()._update(state, xmin, xmax)
        seen = state["count"] > 0
        m = self.momentum
        return {
            "xmin": torch.where(seen, m * xmin + (1 - m) * state["xmin"], xmin),
            "xmax": torch.where(seen, m * xmax + (1 - m) * state["xmax"], xmax),
            "count": state["count"] + 1,
        }


class MSE(MAMinMax):
    """Grid-search range shrinking that minimizes the Lp reconstruction error.

    Defaults as the JAX package's (momentum -1, i.e. accumulate; maxshrink
    0.8; grid 100; norm 2.4). The search walks ``int(maxshrink*grid) + 1``
    shrink factors ``p = 1 - i/grid`` in float32 and keeps, per channel,
    the first strict minimum of the error (``err < best_err``), as the JAX
    ``lax.scan`` does.
    """

    name = "mse"

    def __init__(self, spec: QuantSpec, percentile: float = 0.0, momentum: float = -1.0,
                 maxshrink: float = 0.8, grid: int = 100, norm: float = 2.4, **_):
        super().__init__(spec, percentile, momentum)
        self.maxshrink = float(maxshrink)
        self.grid = int(grid)
        self.norm = float(norm)

    def measure(self, x: torch.Tensor, x_sim: torch.Tensor) -> torch.Tensor:
        """Per-element error; reduced per channel (or in total) by the caller."""
        return torch.abs(x - x_sim) ** self.norm

    def _reduce_err(self, err: torch.Tensor) -> torch.Tensor:
        if self.spec.per_channel:
            return channel_view(err, self.spec.channel_axis).sum(dim=-1)
        return err.sum().reshape(1)

    def grid_search(self, x: torch.Tensor, xmin: torch.Tensor, xmax: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        spec = self.spec
        x = x.float()
        c = xmin.shape[0]
        best_err = torch.full((c,), float("inf"), dtype=torch.float32, device=x.device)
        best_scale = torch.ones((c,), dtype=torch.float32, device=x.device)
        best_zero = torch.zeros((c,), dtype=torch.float32, device=x.device)
        for i in range(int(self.maxshrink * self.grid) + 1):
            p = 1.0 - torch.tensor(float(i), dtype=torch.float32) / self.grid
            p = p.to(x.device)
            s, z = self.quantize(xmin * p, xmax * p)
            sim = fake_quant(x, s, z, spec.qmin, spec.qmax, spec.channel_axis)
            err = self._reduce_err(self.measure(x, sim))
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_scale = torch.where(better, s, best_scale)
            best_zero = torch.where(better, z, best_zero)
        return best_scale, best_zero

    def __call__(self, state: State, x: torch.Tensor, **_) -> Tuple[State, torch.Tensor, torch.Tensor]:
        state, xmin, xmax = self.range(state, x)
        scale, zero = self.grid_search(x, xmin, xmax)
        return state, scale, zero


RANGES.register_dict({"minmax": MinMax, "maminmax": MAMinMax, "mse": MSE})


def build_observer(spec: QuantSpec) -> MinMax:
    """Instantiate the observer named in ``spec.range``."""
    name = spec.range_name
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"observer {name!r} is not ported to quantize_tpu_torch yet "
            "(only 'minmax', 'maminmax' and 'mse'); see ROADMAP.md")
    cls = RANGES.lookup(name)
    return cls(spec, **spec.range_kwargs)
