"""Calibration range observers as ``(state, x) -> (state, scale, zero)``.

PyTorch counterpart of ``quantize_tpu/quant/observers.py``, each a range
estimator of the reference (``modelzoo/modules/range``):

* ``minmax``        -- accumulating min/max (with ``percentile`` clipping)
* ``maminmax``      -- moving-average min/max
* ``mse``           -- Lp-norm grid search over shrink factors
* ``cross_entropy`` -- the same grid search scored by cross entropy
* ``aciq``          -- Laplace-fit analytical clipping
* ``awq``           -- activation-aware weight scaling
  (``(state, w, pre_act, apply_fn) -> (state, scale, zero, awq_scale)``)

plus :class:`BiasCorrect`, which estimates E[x] to correct the
quantization-induced bias. The JAX package's ``lax.scan`` grid loops are
Python loops over the same grid points, keeping the first strict minimum.
Quotients that JAX takes by a Python number divide by a tensor here (on
CUDA PyTorch turns a division by a Python number into a multiplication).

On a mesh of ranks (:mod:`~quantize_tpu_torch.parallel.tensor_parallel`) an
observer may read a part of the tensor JAX reads whole: this rank's rows of
a batch split over ``data``, or this rank's slice of a weight split over
``model``. The caller passes ``split``, the ``(group, axis)`` pairs the
tensor is split on (empty on one device, which keeps the one-device code).
Each step then gives JAX's global-batch semantics: every rank computes its
small statistics, gathers them over each group in one ``all_gather``
(:func:`reduce_stats`) and reduces them locally in rank order, so every
rank holds the same bits (gloo's own reduction order is not the port's to
fix). MinMax and MAMinMax reduce their batch ranges (min of mins, max of
maxes: exact); with ``percentile`` the tensor itself is gathered, the one
gather of a whole activation; MSE and CrossEntropy reduce the range, then
sum the whole grid of candidate errors, one gather; ACIQ reduces its count
and sum before the running mean, then its deviations; AWQ reduces its
input's sums and count before the grid and every ratio's (sum of squares,
count) after it; BiasCorrect reduces the batch's (row sums, rows).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.registry import Registry
from .fakequant import fake_quant
from .qspec import QuantSpec, compute_scale_zero

RANGES = Registry("range observers")

State = Dict[str, torch.Tensor]
# the (process group, axis) pairs a tensor is split on across ranks
Split = Sequence[Tuple[Any, int]]

_REDUCE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def reduce_stats(stats: List[torch.Tensor], ops: Sequence[str], split: Split) -> list:
    """Each of ``stats`` reduced over the ranks of every group of ``split``
    by its op in ``ops``: ``sum``, ``min``, ``max``, or ``count`` (an integer
    count summed exactly, returned as a Python int). One ``all_gather`` a
    group carries all of them (as float64, which holds every float32 value
    and every count exactly); each rank then reduces the gathered rows in
    rank order, so every rank gets the same bits."""
    if not split:
        return list(stats)
    from ..parallel.tensor_parallel import all_gather

    dtypes = [s.dtype for s in stats]
    shapes = [s.shape for s in stats]
    sizes = [s.numel() for s in stats]
    flat = torch.cat([s.detach().double().reshape(-1) for s in stats])
    for group, _ in split:
        rows = all_gather(flat[None], group, dim=0)  # (ranks, n), in rank order
        out = []
        for part, op, dtype in zip(rows.split(sizes, dim=1), ops, dtypes):
            if op == "count":
                out.append(part.sum(dim=0))
                continue
            part = part.to(dtype)
            acc = part[0]
            for r in range(1, part.shape[0]):
                acc = _REDUCE[op](acc, part[r])
            out.append(acc.double())
        flat = torch.cat(out)
    parts = flat.split(sizes)
    return [int(p.sum().item()) if op == "count" else p.to(dtype).reshape(shape)
            for p, op, dtype, shape in zip(parts, ops, dtypes, shapes)]


def gather_split(x: torch.Tensor, split: Split) -> torch.Tensor:
    """``x`` whole: this rank's part gathered, in rank order, along the
    axis of every group of ``split``."""
    from ..parallel.tensor_parallel import all_gather

    for group, axis in split:
        x = all_gather(x, group, dim=axis)
    return x


def channel_view(x: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Reshape to (C, M): channel axis first, everything else flattened."""
    x = torch.movedim(x, channel_axis, 0)
    return x.reshape(x.shape[0], -1)


def _kth_smallest(rows: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest (1-indexed) along the last axis of a (C, M) array."""
    k = max(min(k, rows.shape[-1]), 1)
    return torch.sort(rows, dim=-1).values[..., k - 1]


def group_view(w: torch.Tensor, g: int) -> torch.Tensor:
    """AWQ's ``q_group_size`` grid: (..., in, out) -> (out * K/g, g) with
    K = prod(leading dims), the 2-D (K, N) view first, so a group is g
    consecutive in-features (of one spatial tap, for a conv) of one out
    column."""
    w2 = w.reshape(-1, w.shape[-1])
    if w2.shape[0] % g:
        raise ValueError("flattened in-features must be divisible by q_group_size")
    return w2.T.reshape(-1, g)


def group_unview(wg: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of :func:`group_view`."""
    return wg.reshape(shape[-1], -1).T.reshape(shape)


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

    def batch_range(self, x: torch.Tensor, split: Split = ()) -> Tuple[torch.Tensor, torch.Tensor]:
        """Current-batch (xmin, xmax), shaped (C,) ((1,) for layer gran),
        over the whole of a tensor ``split`` across ranks: the ranks' ranges
        reduced, or with ``percentile`` the tensor gathered whole (exact
        either way)."""
        spec = self.spec
        if split and self.percentile != 0.0:
            return self.batch_range(gather_split(x, split))
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
        xmin, xmax = xmin.float(), xmax.float()
        if split:
            xmin, xmax = reduce_stats([xmin, xmax], ("min", "max"), split)
        return xmin, xmax

    def range(self, state: State, x: torch.Tensor, split: Split = ()
              ) -> Tuple[State, torch.Tensor, torch.Tensor]:
        xmin, xmax = self.batch_range(x, split)
        state = self._update(state, xmin, xmax)
        return state, state["xmin"], state["xmax"]

    def quantize(self, xmin: torch.Tensor, xmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return compute_scale_zero(
            xmin, xmax, self.spec.n_bits, self.spec.symmetric, self.spec.signed
        )

    def __call__(self, state: State, x: torch.Tensor, split: Split = (), **_
                 ) -> Tuple[State, torch.Tensor, torch.Tensor]:
        state, xmin, xmax = self.range(state, x, split)
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

    def grid_search(self, x: torch.Tensor, xmin: torch.Tensor, xmax: torch.Tensor,
                    split: Split = ()) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole grid's errors first (over a tensor ``split`` across
        ranks: this rank's part's errors, the ``(steps, C)`` matrix summed
        over the ranks in one gather), then the first strict minimum."""
        spec = self.spec
        x = x.float()
        c = xmin.shape[0]
        cands, errs = [], []
        for i in range(int(self.maxshrink * self.grid) + 1):
            p = 1.0 - torch.tensor(float(i), dtype=torch.float32) / self.grid
            p = p.to(x.device)
            s, z = self.quantize(xmin * p, xmax * p)
            sim = fake_quant(x, s, z, spec.qmin, spec.qmax, spec.channel_axis)
            cands.append((s, z))
            errs.append(self._reduce_err(self.measure(x, sim)))
        if split:
            errs = list(reduce_stats([torch.stack(errs)], ("sum",), split)[0].unbind(0))
        best_err = torch.full((c,), float("inf"), dtype=torch.float32, device=x.device)
        best_scale = torch.ones((c,), dtype=torch.float32, device=x.device)
        best_zero = torch.zeros((c,), dtype=torch.float32, device=x.device)
        for (s, z), err in zip(cands, errs):
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_scale = torch.where(better, s, best_scale)
            best_zero = torch.where(better, z, best_zero)
        return best_scale, best_zero

    def __call__(self, state: State, x: torch.Tensor, split: Split = (), **_
                 ) -> Tuple[State, torch.Tensor, torch.Tensor]:
        state, xmin, xmax = self.range(state, x, split)
        scale, zero = self.grid_search(x, xmin, xmax, split)
        return state, scale, zero


class CrossEntropy(MSE):
    """CE-based grid search for classifier-head activations.

    Layer granularity and activations only. As the reference does, softmax
    is applied to both tensors, then cross entropy re-applies log-softmax
    to the simulated one.
    """

    name = "cross_entropy"

    def __init__(self, spec: QuantSpec, **kw):
        kw.pop("norm", None)
        super().__init__(spec, **kw)
        if spec.per_channel:
            raise ValueError("cross_entropy observer supports layer granularity only")
        if spec.flag != "activation":
            raise ValueError("cross_entropy observer supports activation quantization only")

    def measure(self, x: torch.Tensor, x_sim: torch.Tensor) -> torch.Tensor:
        p = torch.softmax(x, dim=-1)
        q = torch.log_softmax(torch.softmax(x_sim, dim=-1), dim=-1)
        return -torch.sum(p * q, dim=-1)


class ACIQ(MinMax):
    """Analytical clipping (ACIQ): alpha = C(M)·lambda from a Laplace fit.

    The C tables per bit width, with the fused-ReLU variant, are the
    reference's (``aciq.py:35-44``). The accumulators (count, sum x,
    sum |x - mu|) are carried in the state; lambda accumulates deviations
    against the *running* mean at each step, as in the reference.
    """

    name = "aciq"

    C = [1.86, 2.83, 3.90, 5.03, 6.20, 7.41, 8.65, 9.90,
         11.16, 12.44, 13.73, 15.02, 16.33, 17.64, 18.95, 20.27]
    Cf = [2.83, 3.90, 5.03, 6.20, 7.41, 8.65, 9.90, 11.16,
          12.44, 13.73, 15.02, 16.33, 17.64, 18.95, 20.27, 21.59]

    def __init__(self, spec: QuantSpec, fuse_relu: bool = False, **_):
        super().__init__(spec, percentile=0.0)
        self.fuse_relu = bool(fuse_relu)
        self.eff_bits = min(spec.n_bits, 16)

    def init_state(self, n_channels: int, device=None) -> State:
        return {
            "num": torch.zeros((), dtype=torch.float32, device=device),
            "mu_sum": torch.zeros((n_channels,), dtype=torch.float32, device=device),
            "lam_sum": torch.zeros((n_channels,), dtype=torch.float32, device=device),
        }

    def range(self, state: State, x: torch.Tensor, split: Split = ()
              ) -> Tuple[State, torch.Tensor, torch.Tensor]:
        """Over a tensor ``split`` across ranks: the count and sums reduced
        first (the running mean is the global one), then the deviations
        from it."""
        spec = self.spec
        flat = channel_view(x, spec.channel_axis) if spec.per_channel else x.reshape(1, -1)
        flat = flat.float()
        n, total = flat.shape[-1], flat.sum(dim=-1)
        if split:
            n, total = reduce_stats([torch.tensor(n, device=flat.device), total], ("count", "sum"), split)
        num = state["num"] + n
        mu_sum = state["mu_sum"] + total
        mu = mu_sum / num
        dev = (flat - mu[:, None]).abs().sum(dim=-1)
        if split:
            dev, = reduce_stats([dev], ("sum",), split)
        lam_sum = state["lam_sum"] + dev
        lam = lam_sum / num
        state = {"num": num, "mu_sum": mu_sum, "lam_sum": lam_sum}
        if not self.fuse_relu:
            alpha = self.C[self.eff_bits - 1] * lam
            return state, mu - alpha, mu + alpha
        alpha = self.Cf[self.eff_bits - 1] * lam
        return state, torch.zeros_like(mu), torch.maximum(mu, torch.zeros_like(mu)) + alpha


class AWQ(MinMax):
    """Activation-aware weight scaling (AWQ).

    Grid-searches a per-in-channel scaling ``x_mean^r`` (normalized) that
    minimizes the layer-output MSE after quantizing the scaled weight
    (reference ``awq.py:105-135``). Channel granularity and weights only.
    The caller passes ``pre_act`` (the layer input, in-channel last) and
    ``apply_fn(weight, pre_act) -> output``. Weights are (..., in, out);
    with ``q_group_size`` > 0 each out column's in-features are quantized
    in groups of that size (the 2-D (K, N) view first).
    """

    name = "awq"

    def __init__(self, spec: QuantSpec, q_group_size: int = -1, grid: int = 20,
                 accumulate: bool = True, **_):
        if not spec.per_channel:
            raise ValueError("AWQ only supports channel granularity")
        super().__init__(spec, percentile=0.0)
        self.q_group_size = int(q_group_size)
        self.grid = int(grid)
        self.accumulate = bool(accumulate)

    def init_state(self, n_channels_in: int, device=None) -> State:
        # sized by the IN-channel count (the layers pass it)
        return {"x_mean": torch.zeros((n_channels_in,), dtype=torch.float32, device=device),
                "num_x": torch.zeros((), dtype=torch.float32, device=device)}

    def update_mean(self, state: State, pre_act: torch.Tensor, split: Split = ()) -> State:
        """Running mean of |activation| per in-channel (in-channel last);
        over rows ``split`` across ranks, their sums and count reduced."""
        flat = pre_act.float().abs().reshape(-1, pre_act.shape[-1]).T
        rows = flat.shape[-1]
        if split:
            rows, sums = reduce_stats([torch.tensor(rows, device=flat.device), flat.sum(dim=-1)],
                                      ("count", "sum"), split)
        num = torch.tensor(float(rows), dtype=torch.float32, device=pre_act.device)
        x_mean = sums / num if split else flat.mean(dim=-1)
        if not self.accumulate:
            return {"x_mean": x_mean, "num_x": num}
        seen = state["num_x"] > 0
        tot = state["num_x"] + num
        merged = (state["x_mean"] * state["num_x"] + x_mean * num) / tot
        return {"x_mean": torch.where(seen, merged, x_mean),
                "num_x": torch.where(seen, tot, num)}

    def __call__(self, state: State, w: torch.Tensor, pre_act: Optional[torch.Tensor] = None,
                 apply_fn: Optional[Callable] = None, split: Split = (), pre_split: Split = (),
                 **_):
        """Returns (state, scale, zero, awq_scale). ``pre_split``: the splits
        of ``pre_act``'s rows across ranks (the mean is reduced over them
        before the grid); ``split``: those of ``w``'s out channels. Every
        ratio's loss is then reduced as (sum of squares, count) over both,
        all the grid's in one gather: a slice's output is a slice."""
        if self.spec.flag != "weight":
            raise ValueError("AWQ only supports weight quantization")
        if pre_act is None or apply_fn is None:
            raise ValueError("AWQ needs the layer input (pre_act) and apply_fn")
        spec = self.spec
        dev = w.device
        org_out = apply_fn(w, pre_act)
        state = self.update_mean(state, pre_act, pre_split)
        out_split = (*pre_split, *split)
        x_mean = state["x_mean"]
        grouped = self.q_group_size > 0
        n_scales = (w.numel() // self.q_group_size if grouped else w.shape[spec.channel_axis])
        best_loss = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
        best = (torch.ones((n_scales,), dtype=torch.float32, device=dev),
                torch.zeros((n_scales,), dtype=torch.float32, device=dev),
                torch.ones((x_mean.shape[0],), dtype=torch.float32, device=dev))
        grid = torch.tensor(float(self.grid), dtype=torch.float32)
        cands, losses, sums = [], [], []
        for r in range(self.grid):
            ratio = (torch.tensor(float(r), dtype=torch.float32) / grid).to(dev)
            aws = torch.clamp(x_mean ** ratio, min=1e-4)
            aws = aws / torch.sqrt(aws.max() * aws.min())
            # scale along the in-channel axis (-2 of the weight)
            w_s = w * aws[:, None]
            # per out channel or per group of one out column's in-features
            # (the constructor refuses per tensor): the ranges of a slice of
            # the out channels are its own, with no collective
            if grouped:
                wg = group_view(w_s, self.q_group_size)
                if spec.symmetric:
                    xmin = torch.zeros((wg.shape[0],), dtype=torch.float32, device=dev)
                    xmax = wg.abs().amax(dim=1)
                else:
                    xmin, xmax = wg.amin(dim=1), wg.amax(dim=1)
                s, z = self.quantize(xmin, xmax)
                sim = fake_quant(wg, s, z, spec.qmin, spec.qmax, channel_axis=0)
                w_sim = group_unview(sim, w_s.shape)
            else:
                xmin, xmax = self.batch_range(w_s)
                s, z = self.quantize(xmin, xmax)
                w_sim = fake_quant(w_s, s, z, spec.qmin, spec.qmax, spec.channel_axis)
            w_sim = w_sim / aws[:, None]
            out = apply_fn(w_sim, pre_act)
            sq = (org_out - out).float() ** 2
            cands.append((s, z, aws))
            if out_split:
                sums.append(sq.sum())
            else:
                losses.append(sq.mean())
        if out_split:
            total, count = reduce_stats([torch.stack(sums), torch.tensor(sq.numel(), device=dev)],
                                        ("sum", "count"), out_split)
            losses = list((total / torch.tensor(float(count), device=dev)).unbind(0))
        for cand, loss in zip(cands, losses):
            better = loss < best_loss
            best = tuple(torch.where(better, n, o) for n, o in zip(cand, best))
            best_loss = torch.where(better, loss, best_loss)
        scale, zero, awq_scale = best
        return state, scale, zero, awq_scale


class BiasCorrect:
    """EMA of E[x] for quantization bias correction.

    ``calibrate`` tracks the batch-mean input; ``correction`` runs the layer
    on E[x] with the weight *error* W·static - W_hat and averages over the
    batch (reference ``bias_correct.py:39-63``).
    """

    name = "bias_correct"

    def __init__(self, momentum: float = 0.1, **_):
        self.momentum = float(momentum)

    def init_state(self, sample_shape: Tuple[int, ...], device=None) -> State:
        return {"EX": torch.zeros((1, *sample_shape), dtype=torch.float32, device=device)}

    def calibrate(self, state: State, x: torch.Tensor, split: Split = ()) -> State:
        """One EMA step of the batch mean; over rows ``split`` across ranks,
        their (row sums, rows) reduced."""
        if split:
            sums, rows = reduce_stats([x.float().sum(dim=0, keepdim=True),
                                       torch.tensor(x.shape[0], device=x.device)],
                                      ("sum", "count"), split)
            mean = sums / torch.tensor(float(rows), device=x.device)
        else:
            mean = x.float().mean(dim=0, keepdim=True)
        return {"EX": self.momentum * mean + (1 - self.momentum) * state["EX"]}

    def correction(self, state: State, delta_w: torch.Tensor, apply_fn: Callable) -> torch.Tensor:
        """bias = mean_batch(apply_fn(delta_w, E[x]))."""
        return apply_fn(delta_w, state["EX"]).mean(dim=0)


RANGES.register_dict({
    "minmax": MinMax,
    "maminmax": MAMinMax,
    "mse": MSE,
    "cross_entropy": CrossEntropy,
    "aciq": ACIQ,
    "awq": AWQ,
    "bias_correct": BiasCorrect,
})


def build_observer(spec: QuantSpec) -> MinMax:
    """Instantiate the observer named in ``spec.range``."""
    cls = RANGES.lookup(spec.range_name)
    return cls(spec, **spec.range_kwargs)
