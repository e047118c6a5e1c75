"""Plain fake quantization for the benchmark's references.

Written from the quantization convention alone (no code of the program):

* a weight, symmetric and signed, per output channel: ``s = absmax / (2^(b-1) - 1)``,
  ``q = clamp(round(w / s), -2^(b-1), 2^(b-1) - 1)``, ``w_hat = q * s``;
* an activation, asymmetric, one range per tensor: ``s = (xmax - xmin) / (2^b - 1)``,
  ``z = xmin / s``, ``q = clamp(round(x / s - z), 0, 2^b - 1)``, ``x_hat = (q + z) * s``;
* rounding half to even; a zero scale becomes 1e-12;
* activation ranges as a moving average over the calibration batches: the
  first batch's min and max, then ``m * batch + (1 - m) * running``;
* an MSE weight range (``mse``): of the shrink factors ``p = 1 - i / grid``,
  ``i = 0 .. int(maxshrink * grid)``, the first strict minimum per channel of
  ``sum |w - w_hat(p)|^norm``.

Every division is by a tensor, so that the quotient is the IEEE one.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    return a / torch.full_like(a, float(d))


def _nonzero(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s == 0, torch.full_like(s, EPS), s)


def weight_scale(absmax: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-channel scale of a symmetric signed grid of ``bits``."""
    return _nonzero(_div(absmax, (1 << (bits - 1)) - 1))


def fq_weight(w: torch.Tensor, scale: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """``w`` fake-quantized on a symmetric signed grid; ``scale`` runs along ``axis``."""
    shape = [1] * w.dim()
    shape[axis] = -1
    s = scale.reshape(shape)
    q = torch.clamp(torch.round(w / s), -(1 << (bits - 1)), (1 << (bits - 1)) - 1)
    return q * s


def channel_absmax(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return torch.movedim(w, axis, 0).reshape(w.shape[axis], -1).abs().amax(dim=1)


def minmax_scale(w: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Per-channel scales of min-max ranges."""
    return weight_scale(channel_absmax(w, axis), bits)


def minmax_weight(w: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """``w`` fake-quantized with min-max per-channel ranges."""
    return fq_weight(w, minmax_scale(w, bits, axis), bits, axis)


def mse_weight(w: torch.Tensor, bits: int, axis: int = 0, **kw) -> torch.Tensor:
    """``w`` fake-quantized with the MSE-searched per-channel ranges."""
    return fq_weight(w, mse_scale(w, bits, axis, **kw), bits, axis)


def mse_scale(w: torch.Tensor, bits: int, axis: int = 0, maxshrink: float = 0.8,
              grid: int = 100, norm: float = 2.4) -> torch.Tensor:
    """Per-channel scales of the MSE-searched ranges."""
    absmax = channel_absmax(w, axis)
    wc = torch.movedim(w, axis, 0).reshape(w.shape[axis], -1)
    best_err = torch.full_like(absmax, float("inf"))
    best_s = torch.ones_like(absmax)
    for i in range(int(maxshrink * grid) + 1):
        p = 1.0 - torch.tensor(float(i), dtype=torch.float32, device=w.device) / grid
        s = weight_scale(absmax * p, bits)
        err = (wc - fq_weight(wc, s, bits, 0)).abs().pow(norm).sum(dim=1)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_s = torch.where(better, s, best_s)
    return best_s


class ActRange:
    """A moving-average min/max range of one activation site."""

    def __init__(self, momentum: float):
        self.momentum = float(momentum)
        self.lo = self.hi = None

    def observe(self, x: torch.Tensor) -> None:
        lo, hi = x.amin().float().reshape(1), x.amax().float().reshape(1)
        if self.lo is None:
            self.lo, self.hi = lo, hi
            return
        m = self.momentum
        self.lo = m * lo + (1 - m) * self.lo
        self.hi = m * hi + (1 - m) * self.hi

    def qparams(self, bits: int) -> tuple:
        s = _nonzero(_div(self.hi - self.lo, (1 << bits) - 1))
        return s, self.lo / s


def fq_act(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` fake-quantized on the asymmetric grid ``[0, 2^bits - 1]``."""
    q = torch.clamp(torch.round(x / scale - zero), 0, (1 << bits) - 1)
    return (q + zero) * scale


def fq_train(x: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor, qmin: int, qmax: int,
             axis: int = 0) -> torch.Tensor:
    """Fake quantization with straight-through gradients, for training:
    ``round`` passes its gradient unchanged; the clamp passes none outside
    ``[qmin, qmax]`` (values at the ends pass it); ``scale`` and ``zero``
    (one per channel along ``axis``, or one for the tensor) get theirs."""
    shape = [1] * x.dim()
    if scale.numel() > 1:
        shape[axis] = -1
    s, z = scale.reshape(shape), zero.reshape(shape)
    v = x / s - z
    r = v + (torch.round(v) - v).detach()
    q = torch.where(r > qmax, torch.full_like(r, qmax), torch.where(r < qmin, torch.full_like(r, qmin), r))
    return (q + z) * s


class exact:
    """TF32 off for float32 convolutions and matrix products (on with
    ``tf32``), while the context lasts."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
