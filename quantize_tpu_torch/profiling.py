"""Profiling and roofline accounting.

PyTorch counterpart of ``quantize_tpu/profiling.py`` (the reference has only
wall-clock meters, ``runner/base.py:120-145``):

* :func:`trace` — ``torch.profiler`` over CPU and (where there is a card)
  CUDA activity, written as a Chrome trace.
* :func:`layer_costs` — per-contraction FLOP/byte accounting of a forward,
  with roofline classification against :data:`CHIP_SPECS`.
* :class:`Timer` — wall timing with warm-up, the card synchronized.
* :func:`span` / :func:`spanned` — the program's own ranges (``qtt.<name>``),
  open only while PyTorch's profiler is on, and :func:`span_totals`, their
  host time in the latest profiler session.

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
import functools
import inspect
import json
import math
import os
import threading
import time
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode

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
SPANS_FILE = "spans.json"


# -- the program's spans ------------------------------------------------------
#
# A span is a RecordFunction range named ``qtt.<name>`` around a piece of
# the program's work (a model's forward, a block, a kernel wrapper, a phase of
# a training step, a stage of the serving engine). It exists only while
# PyTorch's profiler is on (``torch.profiler.profile``, ``emit_nvtx``): then
# it shares the device trace's clock (an NVTX range under ``emit_nvtx``) and
# adds its host time and a count to the session totals of its name. With the
# profiler off a span reads that flag, finds no open session to close, and
# does nothing else.

class _NoSpan:
    """The span while the profiler is off: one shared object that does
    nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Session:
    """The totals of the latest profiler session: ``{name: [count, host
    ns]}``. A session starts at the first span that finds the profiler on
    after one that found it off (or after :func:`trace` began), so a
    profiled warm-up, then unprofiled calls, then a profiled stretch leave
    the totals of the stretch alone. Updated under a lock, taken only while
    the profiler is on (the serving engine's threads span concurrently)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals: Dict[str, List[int]] = {}
        self.live = False

    def open(self) -> None:
        with self.lock:
            if not self.live:
                self.totals = {}
                self.live = True

    def add(self, name: str, ns: int) -> None:
        with self.lock:
            entry = self.totals.get(name)
            if entry is None:
                self.totals[name] = [1, ns]
            else:
                entry[0] += 1
                entry[1] += ns


_SESSION = _Session()
# "qtt." + name, made once a name
_LABELS: Dict[str, str] = {}
# the range a span opens: PyTorch's fast RecordFunction where it has one (a
# range on the profiler's host timeline and an NVTX range under emit_nvtx,
# as record_function's, without its two dispatcher calls: on an H100's host
# under the profiler ~35 µs a record_function range, ~8 µs a span on this)
_RANGE = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.profiler.record_function)


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        if not _SESSION.live:
            _SESSION.open()
        label = _LABELS.get(self.name) or _LABELS.setdefault(self.name, "qtt." + self.name)
        self._range = _RANGE(label)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        _SESSION.add(self.name, time.perf_counter_ns() - self._t0)
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one piece of the program's work: the range
    ``qtt.<name>`` while PyTorch's profiler is on, the shared no-op
    otherwise. ``name`` is a constant or fixed when its module is built."""
    if not _autograd_profiler._is_profiler_enabled:
        if _SESSION.live:
            _SESSION.live = False
        return _NO_SPAN
    return _Span(name)


def spanned(name: str) -> Callable:
    """Decorator form of :func:`span`: every call of the function is the
    span ``name``."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                if _SESSION.live:
                    _SESSION.live = False
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def span_totals() -> Dict[str, Tuple[int, float]]:
    """``{name: (count, host seconds)}`` of every span of the latest
    profiler session (empty before the first)."""
    with _SESSION.lock:
        return {k: (c, ns / 1e9) for k, (c, ns) in _SESSION.totals.items()}


# "forward." + mode, made once a mode
_FORWARD_NAMES: Dict[Any, str] = {}


def _forward_name(mode) -> str:
    return _FORWARD_NAMES.get(mode) or _FORWARD_NAMES.setdefault(mode, f"forward.{mode}")


def _spanned_forward(forward, name, mode_at, self, *args, **kwargs):
    if not _autograd_profiler._is_profiler_enabled:
        if _SESSION.live:
            _SESSION.live = False
        return forward(self, *args, **kwargs)
    if name is None:
        at, default = mode_at
        mode = kwargs["mode"] if "mode" in kwargs else (
            args[at] if at is not None and len(args) > at else default)
        name = _forward_name(mode)
    with _Span(name):
        return forward(self, *args, **kwargs)


def span_module(module: torch.nn.Module, name: Optional[str] = None) -> torch.nn.Module:
    """Span every call of ``module``'s forward: as ``name``, or (None, a
    model's top level) as ``forward.<mode>`` by the call's ``mode``. The
    module's class forward runs inside; the instance keeps it through
    ``copy.deepcopy``. Returns ``module``."""
    forward = type(module).forward
    mode_at = (None, None)
    if name is None:
        params = list(inspect.signature(forward).parameters.values())[1:]
        positional = [p.name for p in params
                      if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        default = next((p.default for p in params if p.name == "mode"), None)
        mode_at = (positional.index("mode") if "mode" in positional else None,
                   None if default is inspect.Parameter.empty else default)
    module.forward = types.MethodType(
        functools.partial(_spanned_forward, forward, name, mode_at), module)
    return module


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("results", "torch_trace")):
    """``torch.profiler`` over the block, CUDA activity included where the
    card is there; writes ``<log_dir>/trace.json`` (chrome://tracing or
    Perfetto) and the block's span totals, ``<log_dir>/spans.json``
    (``{name: {"count", "host_s"}}``), on exit. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _SESSION.live = False  # the block's first span opens a session of its own
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
        json.dump({k: {"count": c, "host_s": s} for k, (c, s) in span_totals().items()}, f,
                  indent=1, sort_keys=True)


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
    from .ops import _cost

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
