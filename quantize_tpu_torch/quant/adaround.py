"""AdaRound: learnable rounding offsets (arXiv:2004.10568).

PyTorch counterpart of ``quantize_tpu/quant/adaround.py``:

* ``rect_sigmoid``  — h(V) = clip(sigmoid(V)(ζ−γ)+γ, 0, 1)
* ``init_v``        — inverse of h at the fractional part of x/scale − zero
* ``regularization``— Σ(1 − |2h−1|^β), annealed by β
* ``adaround_round``— floor(v) + h(V) with round-pass-through STE

plus the β schedule of the AdaRound runner. Two details keep the port on
JAX's numbers:

* the clip is ``minimum(maximum(x, 0), 1)``, as ``jnp.clip`` is: at an input
  exactly on 0 or 1 both split the gradient, so it passes 0.5 there
  (``torch.clamp`` would pass 1);
* every division is by a tensor of the same shape or by a float32 number on
  the host: PyTorch computes ``1.2 / t`` as ``reciprocal(t) * 1.2``, and on
  CUDA ``t / 0.8`` as ``t * (1 / 0.8)``, each one rounding away from the true
  quotient JAX computes.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .fakequant import ste_floor_plus

GAMMA = -0.1
ZETA = 1.1


def rect_sigmoid(v: torch.Tensor, gamma: float = GAMMA, zeta: float = ZETA) -> torch.Tensor:
    h = torch.sigmoid(v) * (zeta - gamma) + gamma
    return torch.minimum(torch.maximum(h, h.new_zeros(())), h.new_ones(()))


def init_v(x_over_scale: torch.Tensor, gamma: float = GAMMA, zeta: float = ZETA) -> torch.Tensor:
    """Initialize V so that h(V) equals the fractional part of the input."""
    frac = x_over_scale - torch.floor(x_over_scale)
    frac = torch.clamp(frac, gamma + 1e-6, zeta - 1e-6)
    ratio = torch.full_like(frac, zeta - gamma) / (frac - gamma)
    return -torch.log(ratio - 1.0)


def regularization(v: torch.Tensor, beta: Union[float, torch.Tensor], gamma: float = GAMMA,
                   zeta: float = ZETA, reduction: str = "mean",
                   numel: Optional[int] = None) -> torch.Tensor:
    """Σ(1 − |2h(V)−1|^β), or its mean over ``numel`` elements (default
    ``v.numel()``). ``v`` may be a rank's slice of a V split over the
    ``model`` axis of a mesh: with ``numel`` the whole V's element count,
    the mean is then the slice's share of the whole V's mean (JAX's
    ``jnp.mean`` over a sharded V), whose gradient is the slice of the whole
    gradient; the shares summed over ``model`` give its value."""
    h = rect_sigmoid(v, gamma, zeta)
    # beta as a float32 tensor on v's device, as JAX's traced beta: the
    # power and its gradient then take the general path
    beta = torch.as_tensor(beta, dtype=torch.float32, device=v.device)
    reg = 1.0 - torch.pow(torch.abs(2.0 * h - 1.0), beta)
    if reduction == "mean":
        return reg.sum() / reg.new_full((), float(reg.numel() if numel is None else numel))
    if reduction == "sum":
        return reg.sum()
    return reg


def adaround_round(x_over_scale: torch.Tensor, v: torch.Tensor, gamma: float = GAMMA,
                   zeta: float = ZETA) -> torch.Tensor:
    """floor + h(V) rounding with straight-through hard rounding."""
    return ste_floor_plus(x_over_scale, rect_sigmoid(v, gamma, zeta))


def beta_schedule(current: Union[int, float], total: float, start: float = 20.0,
                  end: float = 2.0, warmup: float = 0.2) -> float:
    """Linearly decay β from ``start`` to ``end`` after a warmup fraction,
    in float32 on the host, operation for operation as JAX computes it."""
    f32 = np.float32
    t = f32(current) / f32(total)
    decayed = f32(start) + f32(end - start) * (t - f32(warmup)) / f32(1.0 - warmup)
    return float(f32(start) if t < f32(warmup) else decayed)
