"""Failure-tolerant training loop: periodic checkpoints + resume.

PyTorch counterpart of ``quantize_tpu/runners/resume.py`` (the reference has
no failure handling at all; its closest artifact is shell scripts skipping
finished output dirs). The runner loop gets:

* periodic checkpoint of all the model's variables + epoch cursor,
* automatic resume from the newest checkpoint on restart,
* the same coarse job-level skip the reference's scripts had
  (``finished`` marker).

A resumed run re-derives its data order from (seed, epoch), as JAX's. What
the checkpoint does not hold starts afresh on resume, as in JAX: the QAT
runner's switch from calibration to training and its optimizer state.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

from ..utils import get_logger


class ResumableRun:
    """Wraps a runner with epoch-granular checkpoint/resume.

    Optional fault-tolerance hooks (:mod:`quantize_tpu_torch.parallel.fault`):

    * ``heartbeat`` — beaten every step so an external supervisor can detect
      a wedged process;
    * ``monitor`` — a :class:`HealthMonitor` observing (loss, step time);
      raises on NaN/exploding loss or stragglers;
    * ``injector`` — a :class:`FaultInjector` for testing the recovery path.

    On a mesh of ranks (the runner's ``mesh``) every rank runs the loop over
    the same output directory: rank 0 alone writes the state file, and the
    ranks meet at a barrier after each write, so that no rank reads it while
    it is written (two ranks writing one ``.tmp`` name interleaved into a
    file that no longer parsed).
    """

    def __init__(self, runner, ckpt_every_epochs: int = 1, state_name: str = "resume_state.json",
                 heartbeat=None, monitor=None, injector=None):
        self.runner = runner
        self.every = max(int(ckpt_every_epochs), 1)
        self.out_dir = runner.cfg.output_dir or "results"
        self.state_path = os.path.join(self.out_dir, state_name)
        self.heartbeat = heartbeat
        self.monitor = monitor
        self.injector = injector
        self.mesh = getattr(runner, "mesh", None)
        self.logger = get_logger()

    # -- state ------------------------------------------------------------
    def _load_state(self) -> dict:
        if os.path.exists(self.state_path):
            with open(self.state_path) as f:
                return json.load(f)
        return {}

    def _save_state(self, **kw) -> None:
        if self.mesh is None or self.mesh.rank == 0:
            os.makedirs(self.out_dir, exist_ok=True)
            state = {**self._load_state(), **kw, "ts": time.time()}
            tmp = self.state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, self.state_path)
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier()

    @property
    def finished(self) -> bool:
        return bool(self._load_state().get("finished"))

    # -- loop -------------------------------------------------------------
    def run(self) -> None:
        if self.finished:
            self.logger.info(f"run already finished ({self.state_path}); skipping")
            return
        runner = self.runner
        state = self._load_state()
        start_epoch = int(state.get("epoch", -1)) + 1
        ckpt = state.get("checkpoint")
        if ckpt and os.path.exists(ckpt):
            runner.load_checkpoint(ckpt)
            self.logger.info(f"resumed from {ckpt} at epoch {start_epoch}")

        if runner.train_loader is None:
            raise ValueError("ResumableRun needs a runner with a train loader")
        from .base import pad_batch

        first = next(iter(runner.train_loader))
        runner.init_variables(pad_batch(first, runner.train_loader.batch_size),
                              seed=runner.cfg.seed or 0)
        runner.total_iters = runner.max_epoch * len(runner.train_loader)

        it = start_epoch * len(runner.train_loader)
        for epoch in range(start_epoch, runner.max_epoch):
            for batch in runner._prefetch(runner.train_loader):
                if self.injector is not None:
                    self.injector.maybe_crash(it)
                t0 = time.perf_counter()
                result = runner.train_step(batch, epoch, it, runner.total_iters)
                if self.monitor is not None and result is not None:
                    loss = result[0] if isinstance(result, tuple) else result
                    if self.injector is not None:
                        loss = self.injector.corrupt_loss(it, loss)
                    self.monitor.observe(loss, time.perf_counter() - t0)
                if self.heartbeat is not None:
                    self.heartbeat.beat(step=it, epoch=epoch)
                it += 1
            runner.update(epoch)
            if (epoch + 1) % self.every == 0 or (epoch + 1) == runner.max_epoch:
                path = os.path.join(self.out_dir, "ckpt_resume.pkl")
                runner.save_checkpoint(path, extra={"epoch": epoch})
                self._save_state(epoch=epoch, checkpoint=path)
        self._save_state(finished=True)


def supervised_run(runner_factory, max_restarts: int = 3, backoff_s: float = 0.01,
                   ckpt_every_epochs: int = 1, monitor_factory=None,
                   injector=None, heartbeat=None, healthcheck=None) -> "ElasticSupervisorResult":
    """Run a training job under elastic supervision.

    ``runner_factory(attempt) -> runner`` builds a fresh runner per attempt
    (a real pod restart re-creates the process; here we re-create the runner).
    Each attempt is wrapped in :class:`ResumableRun` over the same output
    dir, so attempt N+1 resumes from attempt N's newest checkpoint. Returns
    the supervisor (restart events) for observability.
    """
    from ..parallel.fault import ElasticSupervisor

    sup = ElasticSupervisor(max_restarts=max_restarts, backoff_s=backoff_s,
                            healthcheck=healthcheck)

    def work(attempt: int):
        runner = runner_factory(attempt)
        monitor = monitor_factory() if monitor_factory else None
        ResumableRun(runner, ckpt_every_epochs=ckpt_every_epochs,
                     heartbeat=heartbeat, monitor=monitor,
                     injector=injector).run()
        return runner

    runner = sup.run(work)
    return ElasticSupervisorResult(runner=runner, supervisor=sup)


class ElasticSupervisorResult:
    def __init__(self, runner, supervisor):
        self.runner = runner
        self.supervisor = supervisor
        self.restarts = supervisor.events
