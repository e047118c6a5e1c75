"""A bounded traced stretch of the window, kept as a small summary.

``torch.profiler`` (CPU and CUDA activities) runs over the stretch only; the
benchmark marks its own calls with ``record_function`` spans named
``bench.<what>`` (``make``, ``stage``, ``submit``, ``forward``, ``step``,
``drain``, ``sync``). After the stretch the trace is reduced in memory to:
device time and launches by kernel name, the device's busy seconds (the
union of every kernel, copy and set on the card) and the stretch's length,
and the longest idle gaps, each labelled by what the host was doing when it
began (the benchmark's innermost span there, else the innermost operation).
Nothing of the trace is written to disk.
"""
from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict

import torch

WINDOW = "bench.window"
TOP = 10


def span(name: str, on: bool):
    """A ``bench.<name>`` range while tracing, nothing otherwise."""
    return torch.profiler.record_function(f"bench.{name}") if on else contextlib.nullcontext()


def _is_device(evt) -> bool:
    """A kernel, copy or set on the card (not a range the profiler mirrors
    onto the device's timeline)."""
    if getattr(evt, "is_user_annotation", False) or evt.name.startswith("bench."):
        return False
    return getattr(evt.device_type, "name", str(evt.device_type)).upper() == "CUDA"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Stretch:
    """Profiles from :meth:`start` to :meth:`stop` (which synchronizes the
    device first, so that the stretch's kernels are all in the trace)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.summary = None
        self._window = None
        self.units = 0

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self, fn) -> None:
        """Profile one call of ``fn`` and drop it: the tracer's own start-up
        is then paid in set-up, not inside the window."""
        with torch.profiler.profile(activities=self._activities()):
            fn()
            self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        # nothing queued before the stretch runs inside it
        self._sync()
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.summary is None

    def stop(self, units: int) -> dict:
        """End the stretch; ``units`` is the work it held (forwards, batches,
        steps). Returns the summary."""
        self._sync()
        wall = time.perf_counter() - self.t0
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.units = units
        self.summary = summarize(self.prof.events(), wall, units)
        self.prof = None
        return self.summary


def summarize(events, wall_s: float, units: int) -> dict:
    """The stretch's summary from the profiler's events (times in µs)."""
    win = [e for e in events if e.name == WINDOW]
    if win:
        w0, w1 = win[0].time_range.start, win[0].time_range.end
    else:
        w0, w1 = 0.0, wall_s * 1e6
    device, cpu = [], []
    kernels = defaultdict(lambda: [0.0, 0])
    for e in events:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if _is_device(e):
            if b <= a:
                continue
            device.append((a, b))
            kernels[e.name][0] += (b - a) / 1e6
            kernels[e.name][1] += 1
        elif e.name != WINDOW and not getattr(e.device_type, "name", "").upper() == "CUDA":
            cpu.append(e)
    busy = _union(device)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_label(cpu, g0), (g1 - g0) / 1e6] for g0, g1 in gaps[:TOP]]
    ops = sorted(([name, t] for name, (t, _) in kernels.items()), key=lambda x: -x[1])[:TOP]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s, "units": units,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "launches": sum(n for _, n in kernels.values()),
            "breakdown": {"device_ops": [[n[:120], t] for n, t in ops], "idle_gaps": idle}}


def _label(cpu, t: float) -> str:
    """What the host was doing at ``t``: the innermost ``bench.`` span that
    covers it, else the innermost operation that covers it."""
    cover = [e for e in cpu if e.time_range.start <= t <= e.time_range.end]
    mine = [e for e in cover if e.name.startswith("bench.")]
    pick = mine or cover
    if not pick:
        return "host idle"
    return max(pick, key=lambda e: e.time_range.start).name[:120]


def seconds_per_unit(summary, match) -> float | None:
    """Device seconds a unit of work (a forward, a batch, a step) in the
    kernels whose names ``match`` accepts; None where the stretch holds none."""
    if not summary or not summary["units"]:
        return None
    t = sum(s for name, (s, _) in summary["kernels"].items() if match(name))
    return t / summary["units"] if t > 0 else None


def named(*symbols):
    """A matcher of kernel names that hold one of ``symbols`` as a whole word."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, symbols)) + r")\b")
    return lambda name: bool(pat.search(name))
