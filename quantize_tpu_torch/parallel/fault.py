"""Failure detection and elastic recovery.

PyTorch counterpart of ``quantize_tpu/parallel/fault.py`` (the reference
framework has none of this: no retry, no elastic logic; its only
resilience artifact is shell scripts skipping finished output dirs,
``scripts/ptq/minmax.sh:17-19``). The recovery unit is "restart the job and
resume from the newest checkpoint"; this module provides the pieces:

* :class:`Heartbeat` — per-process liveness file; a supervisor (or any other
  host) can detect a dead/wedged process by heartbeat age.
* :class:`HealthMonitor` — in-process failure detection: NaN/Inf loss,
  loss explosion, step-time stragglers.
* :func:`device_healthcheck` — cheap end-to-end probe that the device
  still executes (CUDA unless the caller asks for the CPU).
* :class:`ElasticSupervisor` — retry loop around a resumable unit of work:
  on failure, reload from the newest checkpoint and re-run, with capped
  exponential backoff.
* :class:`FaultInjector` — deterministic fault injection (raise at step k,
  corrupt loss at step k) so the recovery path itself is testable.
"""
from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..utils import get_logger


# ---------------------------------------------------------------------------
# Liveness
# ---------------------------------------------------------------------------

class Heartbeat:
    """Per-process liveness beacon: atomically rewrites a small JSON file.

    Any process sharing the filesystem (other hosts via NFS/GCS-fuse, or a
    local supervisor) can read the file and declare the writer dead when
    ``age() > timeout``.
    """

    def __init__(self, path: str, process_index: int = 0):
        self.path = path
        self.process_index = process_index
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int = -1, **extra: Any) -> None:
        payload = {"ts": time.time(), "pid": os.getpid(),
                   "process_index": self.process_index, "step": step, **extra}
        tmp = f"{self.path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    @staticmethod
    def read(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def age(path: str) -> float:
        """Seconds since the last beat; +inf if never beaten / unreadable."""
        data = Heartbeat.read(path)
        if not data:
            return math.inf
        return time.time() - float(data.get("ts", 0.0))

    @staticmethod
    def dead_processes(dirpath: str, timeout: float) -> List[str]:
        """Heartbeat files in ``dirpath`` older than ``timeout`` seconds."""
        if not os.path.isdir(dirpath):
            return []
        return sorted(
            os.path.join(dirpath, name)
            for name in os.listdir(dirpath)
            if name.endswith(".heartbeat")
            and Heartbeat.age(os.path.join(dirpath, name)) > timeout
        )


def device_healthcheck(device="cuda") -> bool:
    """Probe that ``device`` still executes a trivial program: a sum of
    0..7 computed there and read back. Catches wedged devices that surface
    as hangs or garbage rather than Python exceptions. Cheap enough to run
    between epochs."""
    import torch

    try:
        x = torch.arange(8, dtype=torch.float32, device=torch.device(device))
        return float(x.sum()) == 28.0
    except Exception:  # noqa: BLE001 - any failure means unhealthy
        return False


# ---------------------------------------------------------------------------
# In-process failure detection
# ---------------------------------------------------------------------------

class TrainingDiverged(RuntimeError):
    """Raised by :class:`HealthMonitor` when the loss goes NaN/Inf/explodes."""


class StragglerDetected(RuntimeError):
    """Raised when a step exceeds the straggler threshold."""


@dataclass
class HealthMonitor:
    """Streaming failure detector over (loss, step-time) observations.

    * NaN/Inf loss -> :class:`TrainingDiverged` immediately.
    * loss > ``explode_factor`` x running mean (after warmup) -> diverged.
    * step time > ``straggler_factor`` x running mean (after warmup) ->
      :class:`StragglerDetected` (on a pod this is the signal to probe the
      slow host / restart the job before it wedges the collective).
    """

    explode_factor: float = 100.0
    straggler_factor: float = 10.0
    warmup_steps: int = 8
    momentum: float = 0.95
    _loss_mean: float = field(default=0.0, init=False)
    _time_mean: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)

    def observe(self, loss: float, step_time: Optional[float] = None) -> None:
        loss = float(loss)
        if math.isnan(loss) or math.isinf(loss):
            raise TrainingDiverged(f"loss is {loss} at step {self._n}")
        if self._n >= self.warmup_steps:
            if abs(loss) > self.explode_factor * max(abs(self._loss_mean), 1e-12):
                raise TrainingDiverged(
                    f"loss {loss:.4g} exploded vs running mean "
                    f"{self._loss_mean:.4g} at step {self._n}")
            if (step_time is not None and self._time_mean > 0
                    and step_time > self.straggler_factor * self._time_mean):
                raise StragglerDetected(
                    f"step {self._n} took {step_time:.3f}s vs mean "
                    f"{self._time_mean:.3f}s")
        m = self.momentum if self._n else 0.0
        self._loss_mean = m * self._loss_mean + (1 - m) * loss
        if step_time is not None:
            self._time_mean = m * self._time_mean + (1 - m) * step_time
        self._n += 1


# ---------------------------------------------------------------------------
# Fault injection (for tests of the recovery path)
# ---------------------------------------------------------------------------

class InjectedFault(RuntimeError):
    pass


class FaultInjector:
    """Deterministic fault source: fire once at each configured step.

    ``crash_at`` raises :class:`InjectedFault`; ``nan_loss_at`` makes
    :meth:`corrupt_loss` return NaN for that step. Each fires exactly once
    per injector instance so a supervised retry makes progress.
    """

    def __init__(self, crash_at: Optional[List[int]] = None,
                 nan_loss_at: Optional[List[int]] = None):
        self._crash_at = set(crash_at or [])
        self._nan_at = set(nan_loss_at or [])

    def maybe_crash(self, step: int) -> None:
        if step in self._crash_at:
            self._crash_at.discard(step)
            raise InjectedFault(f"injected crash at step {step}")

    def corrupt_loss(self, step: int, loss: float) -> float:
        if step in self._nan_at:
            self._nan_at.discard(step)
            return float("nan")
        return loss


# ---------------------------------------------------------------------------
# Elastic supervision
# ---------------------------------------------------------------------------

@dataclass
class RestartEvent:
    attempt: int
    error: str
    backoff_s: float


class ElasticSupervisor:
    """Retry a resumable unit of work until it completes.

    ``work(attempt) -> result`` must be resumable — i.e. restore its own
    progress from checkpoints (e.g. :class:`~quantize_tpu_torch.runners.
    resume.ResumableRun`). The supervisor catches failures, waits with capped
    exponential backoff, optionally verifies device health, and re-invokes.
    Non-transient errors (anything in ``fatal``) propagate immediately.
    """

    def __init__(self, max_restarts: int = 3, backoff_s: float = 0.5,
                 backoff_cap_s: float = 30.0,
                 fatal: tuple = (KeyboardInterrupt, SystemExit),
                 healthcheck: Optional[Callable[[], bool]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.fatal = fatal
        self.healthcheck = healthcheck
        self.sleep = sleep
        self.events: List[RestartEvent] = []
        self.logger = get_logger()

    def run(self, work: Callable[[int], Any]) -> Any:
        attempt = 0
        while True:
            try:
                return work(attempt)
            except self.fatal:
                raise
            except Exception as e:  # noqa: BLE001 - supervision boundary
                attempt += 1
                if attempt > self.max_restarts:
                    self.logger.info(
                        f"giving up after {self.max_restarts} restarts: {e!r}")
                    raise
                wait = min(self.backoff_s * (2 ** (attempt - 1)),
                           self.backoff_cap_s)
                self.events.append(RestartEvent(attempt, repr(e), wait))
                self.logger.info(
                    f"restart {attempt}/{self.max_restarts} after {e!r}; "
                    f"backing off {wait:.1f}s")
                self.sleep(wait)
                if self.healthcheck is not None and not self.healthcheck():
                    self.logger.info("healthcheck failed after restart; aborting")
                    raise
