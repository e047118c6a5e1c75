"""Optimizers and learning-rate schedules, as optax computes them, on tensors.

PyTorch counterpart of ``quantize_tpu/optim.py``: the optimizers adam,
adamw, sgd (momentum, nesterov, weight decay) and rmsprop, and the schedules
constant, step, multistep, exponential, cosine, cosine_warmup and
linear_warmup, each a function of the optimizer's step count as optax
counts it (0 on the first update), converted from the reference's per-epoch
settings by ``steps_per_epoch``.

optax's update rules are written out by hand, not taken from
``torch.optim``, whose rules differ: ``RMSprop`` adds ``eps`` outside the
square root where optax's ``scale_by_rms`` adds it inside, ``Adam`` updates
its first moment with ``lerp_`` and divides in another order, and
``ExponentialLR`` steps once an epoch where optax's ``exponential_decay``
is continuous. Each rule keeps optax's order of float32 operations:

* a schedule is evaluated in float32 on the host (the powers and the
  cosine rounded from float64, as XLA's are), and its value multiplies the
  update as a float32 number;
* the moments are ``(1 - b) * g + b * m``, the bias corrections divide by
  ``1 - b ** count`` as a float32 tensor (a true division, on CUDA too),
  and ``rmsprop`` scales by ``rsqrt(nu + eps)`` (XLA's float32 rsqrt and
  PyTorch's differ by an ulp on some inputs).

An optimizer is a chain of :class:`Transform` s over a dict of tensors keyed
``"collection/path/leaf"`` (:func:`~quantize_tpu_torch.nn.variables.trainable`);
:class:`Optimizer` holds the state and updates the tensors in place. The
chains the registry builds for ``adam`` and ``adamw`` (and such a chain
followed by :class:`Scale`, alone or as a label of a :class:`Partition`)
update their leaves through one fused launch a step (kernel KA,
:mod:`~quantize_tpu_torch.ops.adam`), bit-equal to the chain leaf by leaf;
every other transform, and a leaf the fused update does not take, runs leaf
by leaf.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .ops.adam import AdamScalars, adam_update
from .utils.registry import Registry

OPTIMIZERS = Registry("optimizers")
SCHEDULERS = Registry("lr schedulers")

Tensors = Dict[str, torch.Tensor]
f32 = np.float32


def _get(cfg: Any, key: str, default=None):
    v = getattr(cfg, key, None) if cfg is not None else None
    return default if v is None else v


def _pow(base: float, exponent) -> np.float32:
    """float32 ``base ** exponent`` rounded from float64, as XLA's power
    of a float32 base gives it."""
    return f32(np.float64(f32(base)) ** np.float64(exponent))


def _cos(x: np.float32) -> np.float32:
    """float32 cosine rounded from float64, as XLA's gives it."""
    return f32(np.cos(np.float64(x)))


# ---------------------------------------------------------------------------
# schedules: count (0 on the first update) -> learning rate (a float32 value)
# ---------------------------------------------------------------------------

@SCHEDULERS.register(name="constant")
def constant(lr: float, steps_per_epoch: int, cfg=None) -> Callable[[int], float]:
    return lambda count: float(f32(lr))


@SCHEDULERS.register(name="step")
def step(lr: float, steps_per_epoch: int, cfg=None) -> Callable[[int], float]:
    step_size = _get(cfg, "step_size", 30) * steps_per_epoch
    gamma = _get(cfg, "gamma", 0.1)
    return lambda count: float(f32(lr) * _pow(gamma, count // step_size))


def _piecewise_constant(lr: float, boundaries: Mapping[int, float]) -> Callable[[int], float]:
    """optax's ``piecewise_constant_schedule``: at each boundary reached
    (count >= boundary) the value is multiplied by its scale."""
    def schedule(count):
        v = f32(lr)
        for threshold, scale in sorted(boundaries.items()):
            if count >= threshold:
                v = f32(scale) * v
        return float(v)

    return schedule


@SCHEDULERS.register(name="multistep")
def multistep(lr: float, steps_per_epoch: int, cfg=None) -> Callable[[int], float]:
    milestones: Sequence[int] = _get(cfg, "milestones", [30, 60])
    gamma = _get(cfg, "gamma", 0.1)
    return _piecewise_constant(lr, {int(m * steps_per_epoch): gamma for m in milestones})


@SCHEDULERS.register(name="exponential")
def exponential(lr: float, steps_per_epoch: int, cfg=None) -> Callable[[int], float]:
    """optax's continuous ``exponential_decay``: ``lr * gamma ** (count /
    steps_per_epoch)``."""
    gamma = _get(cfg, "gamma", 0.9)
    if steps_per_epoch <= 0 or gamma == 0:
        return lambda count: lr

    def schedule(count):
        if count <= 0:
            return float(f32(lr))
        return float(f32(lr) * _pow(gamma, f32(count) / f32(steps_per_epoch)))

    return schedule


def _cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1.0) + _cos(f32(math.pi) * c / f32(decay_steps)))
        return float(f32(lr) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax's ``linear_schedule`` (``polynomial_schedule`` at power 1)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = f32(1.0) - f32(min(max(count, 0), steps)) / f32(steps)
        return float(f32(init - end) * frac + f32(end))

    return schedule


def _join(schedules: Sequence[Callable[[int], float]], boundaries: Sequence[int]):
    """optax's ``join_schedules``: past a boundary the next schedule runs on
    the steps counted from it."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return float(f32(out))

    return schedule


@SCHEDULERS.register(name="cosine")
def cosine(lr: float, steps_per_epoch: int, cfg=None) -> Callable[[int], float]:
    total = _get(cfg, "t_max", _get(cfg, "max_epoch", 100)) * steps_per_epoch
    return _cosine_decay(lr, max(total, 1))


@SCHEDULERS.register(name="cosine_warmup")
def cosine_warmup(lr: float, steps_per_epoch: int, cfg=None) -> Callable[[int], float]:
    warmup_epochs = _get(cfg, "warmup_epoch", 5)
    total = _get(cfg, "max_epoch", 100) * steps_per_epoch
    warmup = max(int(warmup_epochs * steps_per_epoch), 1)
    decay_steps = max(total, warmup + 1)
    return _join([_linear(_get(cfg, "warmup_lr", 0.0), lr, warmup),
                  _cosine_decay(lr, decay_steps - warmup)], [warmup])


@SCHEDULERS.register(name="linear_warmup")
def linear_warmup(lr: float, steps_per_epoch: int, cfg=None) -> Callable[[int], float]:
    warmup_epochs = _get(cfg, "warmup_epoch", 5)
    warmup = max(int(warmup_epochs * steps_per_epoch), 1)
    return _join([_linear(_get(cfg, "warmup_lr", 0.0), lr, warmup), constant(lr, 1)], [warmup])


def build_lr_scheduler(cfg: Any, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """The schedule of ``cfg.lr_scheduler`` at ``cfg.optimizer.lr``; a key
    missing from ``cfg.lr_scheduler`` is looked up in ``cfg.train``."""
    sched_cfg = getattr(cfg, "lr_scheduler", None)
    lr = float(_get(getattr(cfg, "optimizer", None), "lr", 1e-3))
    name = _get(sched_cfg, "name", "constant")

    class _Merged:
        def __getattr__(self, k):
            for node in (sched_cfg, getattr(cfg, "train", None)):
                v = getattr(node, k, None) if node is not None else None
                if v is not None:
                    return v
            return None

    return SCHEDULERS.build(name, lr, steps_per_epoch, _Merged())


# ---------------------------------------------------------------------------
# gradient transformations (optax's, on dicts of tensors)
# ---------------------------------------------------------------------------

class Transform:
    """One of optax's gradient transformations: ``init(params) -> state``,
    ``update(updates, state, params) -> (updates, state)``."""

    def init(self, params: Tensors) -> Any:
        return None

    def update(self, updates: Tensors, state: Any, params: Tensors):
        raise NotImplementedError


def _scalar_like(t: torch.Tensor, value) -> torch.Tensor:
    return torch.full((), float(value), dtype=t.dtype, device=t.device)


class ScaleByAdam(Transform):
    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def bias_corrections(self, count: int):
        """``(1 - b1 ** count, 1 - b2 ** count)`` as float32 values."""
        return f32(1.0) - _pow(self.b1, count), f32(1.0) - _pow(self.b2, count)

    def update(self, updates, state, params):
        count = state["count"] + 1
        c1, c2 = self.bias_corrections(count)
        out = {}
        for k, g in updates.items():
            mu, nu = state["mu"][k], state["nu"][k]
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1 - self.b2))
            mu_hat = mu / _scalar_like(mu, c1)
            nu_hat = nu / _scalar_like(nu, c2)
            out[k] = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return out, {**state, "count": count}


class ScaleByRms(Transform):
    """optax's ``scale_by_rms`` (``eps`` inside the square root)."""

    def __init__(self, decay: float = 0.9, eps: float = 1e-8):
        self.decay, self.eps = decay, eps

    def init(self, params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(self, updates, state, params):
        out = {}
        for k, g in updates.items():
            nu = state[k]
            nu.mul_(self.decay).add_(g * g * (1 - self.decay))
            out[k] = torch.rsqrt(nu + self.eps) * g
        return out, state


class Trace(Transform):
    """optax's ``trace``: momentum, with ``nesterov`` the look-ahead."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(self, updates, state, params):
        out = {}
        for k, g in updates.items():
            t = state[k]
            t.copy_(g + self.decay * t)
            out[k] = g + self.decay * t if self.nesterov else t.clone()
        return out, state


class AddDecayedWeights(Transform):
    def __init__(self, weight_decay: float):
        self.weight_decay = weight_decay

    def update(self, updates, state, params):
        return {k: g + self.weight_decay * params[k] for k, g in updates.items()}, state


class Scale(Transform):
    def __init__(self, step_size: float):
        self.step_size = float(f32(step_size))

    def update(self, updates, state, params):
        return {k: self.step_size * g for k, g in updates.items()}, state


class ScaleByLearningRate(Transform):
    """The update times ``-schedule(count)``, the count before this update."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def init(self, params):
        return 0

    def update(self, updates, state, params):
        step_size = float(-f32(self.schedule(state)))
        return {k: step_size * g for k, g in updates.items()}, state + 1


class Chain(Transform):
    def __init__(self, *transforms: Transform):
        self.transforms = transforms

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def update(self, updates, state, params):
        new = []
        for t, s in zip(self.transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, new


class Partition(Transform):
    """optax's ``multi_transform``: each label's transform over the leaves
    ``label_fn(key)`` gives that label, with a state of its own."""

    def __init__(self, transforms: Mapping[str, Transform], label_fn: Callable[[str], str]):
        self.transforms, self.label_fn = dict(transforms), label_fn

    def _split(self, tree: Tensors) -> Dict[str, Tensors]:
        out = {label: {} for label in self.transforms}
        for k, v in tree.items():
            out[self.label_fn(k)][k] = v
        return out

    def init(self, params):
        parts = self._split(params)
        return {label: t.init(parts[label]) for label, t in self.transforms.items()}

    def update(self, updates, state, params):
        ups, ps = self._split(updates), self._split(params)
        out, new = {}, {}
        for label, t in self.transforms.items():
            u, new[label] = t.update(ups[label], state[label], ps[label])
            out.update(u)
        return {k: out[k] for k in updates}, new


def _at(state, path: Sequence[int]):
    for i in path:
        state = state[i]
    return state


class _FusedAdam:
    """A chain :func:`_fused_adam` recognised: ``ScaleByAdam``, an optional
    ``AddDecayedWeights``, ``ScaleByLearningRate``, optionally then
    ``Scale``; ``adam_at`` and ``lr_at`` index the Adam state and the
    schedule's count in the chain's state."""

    def __init__(self, tx: Transform, adam: ScaleByAdam, wd: Optional[float],
                 lr: ScaleByLearningRate, qs: Optional[float], adam_at: tuple, lr_at: tuple):
        self.tx, self.adam, self.wd, self.lr, self.qs = tx, adam, wd, lr, qs
        self.adam_at, self.lr_at = adam_at, lr_at

    def scalars(self, state) -> AdamScalars:
        """The step's scalars, each rounded to float32 as the chain's
        transforms round them leaf by leaf."""
        a = self.adam
        c1, c2 = a.bias_corrections(_at(state, self.adam_at)["count"] + 1)
        return AdamScalars(
            float(f32(a.b1)), float(f32(a.b2)), float(f32(1 - a.b1)), float(f32(1 - a.b2)),
            float(f32(a.eps)), float(c1), float(c2),
            None if self.wd is None else float(f32(self.wd)),
            float(-f32(self.lr.schedule(_at(state, self.lr_at)))),
            None if self.qs is None else float(f32(self.qs)))

    def step(self, params: Tensors, grads, state, routes: Dict[str, int]):
        """One update of ``params`` in place; returns the chain's new state.
        The leaves :func:`~quantize_tpu_torch.ops.adam.adam_update` takes
        go through the fused update, the rest through the chain leaf by
        leaf, whose update (over no leaves, where none is left) also moves
        the chain's counts."""
        moments = _at(state, self.adam_at)
        mu, nu = moments["mu"], moments["nu"]
        keys = list(params)
        refused = adam_update([(params[k], grads.get(k), mu[k], nu[k]) for k in keys],
                              self.scalars(state))
        rest = {keys[i]: params[keys[i]] for i in refused}
        routes["fused"] += len(keys) - len(rest)
        routes["per_leaf"] += len(rest)
        return _per_leaf(self.tx, rest, grads, state)


def _fused_adam(tx: Transform) -> Optional[_FusedAdam]:
    """The fused form of ``tx`` if it is a chain the registry builds for
    ``adam`` or ``adamw``, alone or followed by ``Scale``; else None."""
    if type(tx) is not Chain:
        return None
    ts = tx.transforms
    if len(ts) == 2 and type(ts[1]) is Scale:
        inner = _fused_adam(ts[0])
        if inner is None or inner.qs is not None:
            return None
        return _FusedAdam(tx, inner.adam, inner.wd, inner.lr, ts[1].step_size,
                          (0, *inner.adam_at), (0, *inner.lr_at))
    if (len(ts) in (2, 3) and type(ts[0]) is ScaleByAdam and type(ts[-1]) is ScaleByLearningRate
            and (len(ts) == 2 or type(ts[1]) is AddDecayedWeights)):
        return _FusedAdam(tx, ts[0], ts[1].weight_decay if len(ts) == 3 else None, ts[-1], None,
                          (0,), (len(ts) - 1,))
    return None


def _per_leaf(tx: Transform, params: Tensors, grads, state):
    """``tx``'s update of ``params`` leaf by leaf (a missing gradient as
    zeros), applied in place; returns the new state."""
    grads = {k: torch.zeros_like(p) if grads.get(k) is None else grads[k]
             for k, p in params.items()}
    updates, state = tx.update(grads, state, params)
    for k, p in params.items():
        p.add_(updates[k])
    return state


class Optimizer:
    """A transform and its state over named tensors: :meth:`step` applies
    one update to the tensors in place (optax's ``apply_updates``). The
    tensors are looked up by name at each step, so a leaf that a module
    replaced keeps its optimizer state.

    A chain :func:`_fused_adam` recognises (the whole transform, or a label
    of a :class:`Partition`) updates its leaves through kernel KA;
    ``route_leaves`` counts the leaves updated on each route, ``"fused"``
    and ``"per_leaf"``, over every step."""

    def __init__(self, tx: Transform, params: Tensors):
        self.tx = tx
        self.state = tx.init(params)
        self.route_leaves = {"fused": 0, "per_leaf": 0}
        if type(tx) is Partition:
            self._fused = {label: _fused_adam(t) for label, t in tx.transforms.items()}
        else:
            self._fused = _fused_adam(tx)

    def _update(self, tx: Transform, fused: Optional[_FusedAdam], params: Tensors, grads, state):
        if fused is not None:
            return fused.step(params, grads, state, self.route_leaves)
        self.route_leaves["per_leaf"] += len(params)
        return _per_leaf(tx, params, grads, state)

    @torch.no_grad()
    def step(self, params: Tensors, grads: Mapping[str, Optional[torch.Tensor]]) -> None:
        tx = self.tx
        if type(tx) is not Partition:
            self.state = self._update(tx, self._fused, params, grads, self.state)
            return
        parts = tx._split(params)
        self.state = {label: self._update(t, self._fused[label], parts[label], grads,
                                          self.state[label])
                      for label, t in tx.transforms.items()}


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@OPTIMIZERS.register(name="adam")
def adam(schedule, cfg=None) -> Transform:
    return Chain(ScaleByAdam(_get(cfg, "beta1", 0.9), _get(cfg, "beta2", 0.999),
                             _get(cfg, "eps", 1e-8)),
                 ScaleByLearningRate(schedule))


@OPTIMIZERS.register(name="adamw")
def adamw(schedule, cfg=None) -> Transform:
    return Chain(ScaleByAdam(_get(cfg, "beta1", 0.9), _get(cfg, "beta2", 0.999),
                             _get(cfg, "eps", 1e-8)),
                 AddDecayedWeights(_get(cfg, "weight_decay", 1e-2)),
                 ScaleByLearningRate(schedule))


@OPTIMIZERS.register(name="sgd")
def sgd(schedule, cfg=None) -> Transform:
    # momentum defaults to 0 like the reference (optim/optimizer.py:49-55)
    momentum = _get(cfg, "momentum", 0.0)
    wd = _get(cfg, "weight_decay", 0.0)
    parts = [AddDecayedWeights(wd)] if wd else []
    if momentum:
        parts.append(Trace(momentum, bool(_get(cfg, "nesterov", False))))
    return Chain(*parts, ScaleByLearningRate(schedule))


@OPTIMIZERS.register(name="rmsprop")
def rmsprop(schedule, cfg=None) -> Transform:
    return Chain(ScaleByRms(_get(cfg, "alpha", 0.99), _get(cfg, "eps", 1e-8)),
                 ScaleByLearningRate(schedule),
                 Trace(_get(cfg, "momentum", 0.0)))


def build_optimizer(cfg: Any, steps_per_epoch: int = 1) -> Transform:
    """The optimizer of ``cfg.optimizer`` with its schedule."""
    opt_cfg = getattr(cfg, "optimizer", None)
    name = _get(opt_cfg, "name", "adam")
    return OPTIMIZERS.build(name, build_lr_scheduler(cfg, steps_per_epoch), opt_cfg)


__all__ = ["OPTIMIZERS", "SCHEDULERS", "Optimizer", "Partition", "Scale", "Transform",
           "build_lr_scheduler", "build_optimizer"]
