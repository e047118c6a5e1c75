"""Profiling and roofline accounting.

PyTorch counterpart of ``quantize_tpu/profiling.py`` (the reference has only
wall-clock meters, ``runner/base.py:120-145``):

* :func:`trace` — ``torch.profiler`` over CPU and (where there is a card)
  CUDA activity, written as a Chrome trace.
* :func:`layer_costs` — per-contraction FLOP/byte accounting of a forward,
  with roofline classification against :data:`CHIP_SPECS`.
* :class:`Timer` — wall timing with warm-up, the card synchronized.

JAX counts every ``dot_general`` and ``conv_general_dilated`` of the
traced program; here :func:`layer_costs` runs the function once and counts
the same contractions as they reach PyTorch's dispatcher (``aten`` mm,
addmm, bmm, baddbmm, ``_int_mm``, mv, dot, convolution), under JAX's names.
The hand-written kernels launch through ``ctypes``, out of the
dispatcher's sight: each contraction kernel's wrapper reports its own cost
under its kernel's name (:mod:`quantize_tpu_torch.ops._cost`), on the card
and on the CPU alike.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .ops import _cost

# chip peak specs (per chip): dense bf16 FLOP/s, int8 OP/s, HBM bytes/s; the
# H100 (NVIDIA's data sheet, SXM part, dense rates) also float32 outside the
# tensor cores, the rate of a float32 contraction with TF32 off
CHIP_SPECS = {
    "tpu_v5e": {"bf16": 197e12, "int8": 394e12, "hbm": 819e9},
    "tpu_v4": {"bf16": 275e12, "int8": 275e12, "hbm": 1228e9},
    "cpu": {"bf16": 1e11, "int8": 1e11, "hbm": 5e10},
    "h100_sxm": {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "hbm": 3.35e12},
}
DEFAULT_CHIP = "h100_sxm"
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("results", "torch_trace")):
    """``torch.profiler`` over the block, CUDA activity included where the
    card is there; writes ``<log_dir>/trace.json`` (chrome://tracing or
    Perfetto) on exit. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclasses.dataclass
class OpCost:
    name: str
    flops: float
    bytes: float
    dtype_bits: int

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1)

    def _peak(self, spec: Dict[str, float]) -> float:
        if self.dtype_bits <= 8:
            return spec["int8"]
        if self.dtype_bits >= 32 and "f32" in spec:
            return spec["f32"]
        return spec["bf16"]

    def bound(self, chip: str = DEFAULT_CHIP) -> str:
        spec = CHIP_SPECS[chip]
        ridge = self._peak(spec) / spec["hbm"]
        return "compute" if self.intensity >= ridge else "memory"

    def min_time_s(self, chip: str = DEFAULT_CHIP) -> float:
        spec = CHIP_SPECS[chip]
        return max(self.flops / self._peak(spec), self.bytes / spec["hbm"])


_aten = torch.ops.aten
# aten contraction -> (JAX primitive name, positions of its two operands)
_CONTRACTIONS = {
    _aten.mm: ("dot_general", 0, 1), _aten.addmm: ("dot_general", 1, 2),
    _aten.bmm: ("dot_general", 0, 1), _aten.baddbmm: ("dot_general", 1, 2),
    _aten._int_mm: ("dot_general", 0, 1), _aten.mv: ("dot_general", 0, 1),
    _aten.dot: ("dot_general", 0, 1), _aten.convolution: ("conv_general_dilated", 0, 1),
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CostRecorder(TorchDispatchMode):
    """Records each contraction that reaches the dispatcher, and each
    kernel wrapper's report (``ops/_cost.py``), as :class:`OpCost`."""

    def __init__(self):
        super().__init__()
        self.costs: List[OpCost] = []
        self.suppressed = 0

    def kernel(self, name: str, ops: int, nbytes: int, bits: int) -> None:
        self.costs.append(OpCost(name, float(ops), float(nbytes), bits))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        entry = _CONTRACTIONS.get(func.overloadpacket)
        if entry is not None and not self.suppressed:
            name, ia, ib = entry
            a, b = args[ia], args[ib]
            if name == "conv_general_dilated":
                # OIHW weight: each output sums kh * kw * (ci / groups) products
                flops = 2 * out.numel() * math.prod(b.shape[1:])
            else:
                flops = 2 * a.shape[-1] * out.numel()
            bits = min(a.element_size(), b.element_size()) * 8
            self.costs.append(OpCost(name, float(flops),
                                     float(_nbytes(a) + _nbytes(b) + _nbytes(out)), bits))
        return out


def layer_costs(fn: Callable, *args, chip: str = DEFAULT_CHIP) -> List[OpCost]:
    """Run ``fn(*args)`` once (no autograd) and account every matmul/conv
    it runs and every kernel wrapper it calls: FLOPs, bytes, operand bits.
    ``chip`` is accepted for JAX's signature; :meth:`OpCost.bound` and
    :meth:`OpCost.min_time_s` take it."""
    rec = _CostRecorder()
    _cost._ACTIVE.append(rec)
    try:
        with torch.no_grad(), rec:
            fn(*args)
    finally:
        _cost._ACTIVE.remove(rec)
    return rec.costs


def roofline_report(fn: Callable, *args, chip: str = DEFAULT_CHIP) -> Dict[str, Any]:
    """Aggregate roofline summary of a forward function."""
    costs = layer_costs(fn, *args, chip=chip)
    total_flops = sum(c.flops for c in costs)
    total_bytes = sum(c.bytes for c in costs)
    min_time = sum(c.min_time_s(chip) for c in costs)
    return {
        "n_ops": len(costs),
        "total_gflops": total_flops / 1e9,
        "total_mbytes": total_bytes / 1e6,
        "compute_bound_ops": sum(1 for c in costs if c.bound(chip) == "compute"),
        "memory_bound_ops": sum(1 for c in costs if c.bound(chip) == "memory"),
        "speed_of_light_ms": min_time * 1e3,
    }


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timing with warmup; the card synchronized before the clock
    starts and after the last call (JAX's ``block_until_ready``)."""

    def __init__(self, fn: Callable, warmup: int = 2, iters: int = 10):
        self.fn = fn
        self.warmup = warmup
        self.iters = iters

    def __call__(self, *args) -> float:
        for _ in range(self.warmup):
            self.fn(*args)
        _sync()
        t0 = time.perf_counter()
        for _ in range(self.iters):
            self.fn(*args)
        _sync()
        return (time.perf_counter() - t0) / self.iters
