"""Failure detection + elastic recovery in the port
(``quantize_tpu_torch.parallel.fault``), on the CPU: each case of the JAX
package's ``tests/test_fault.py`` against the port's module (heartbeats,
health monitoring, the device probe, fault injection, the supervisor, and
the supervised end-to-end recovery over the port's PTQ runner on TestCNN).
``tests/test_torch_resume.py`` holds the supervised runs against JAX's.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from quantize_tpu_torch.parallel import (
    ElasticSupervisor,
    FaultInjector,
    HealthMonitor,
    Heartbeat,
    InjectedFault,
    StragglerDetected,
    TrainingDiverged,
    device_healthcheck,
)
import quantize_tpu_torch.runners as runners
from quantize_tpu_torch.data import DataLoader, make_synthetic
from quantize_tpu_torch.runners.resume import supervised_run
from quantize_tpu_torch.utils import Config, Logger

import test_resume


def make_cfg(tmp_path, max_epoch=4):
    return Config(test_resume.make_cfg(tmp_path, max_epoch).to_dict())


def make_loader():
    return DataLoader(make_synthetic(n=64, image_size=8, num_classes=4), batch_size=32)


def build_runner(cfg, *loaders):
    return runners.build_runner(cfg, *loaders, device="cpu")


# -- Heartbeat ---------------------------------------------------------------

def test_heartbeat_beat_and_age(tmp_path):
    path = str(tmp_path / "p0.heartbeat")
    hb = Heartbeat(path, process_index=0)
    assert Heartbeat.age(path) == float("inf")
    hb.beat(step=7, epoch=1)
    data = Heartbeat.read(path)
    assert data["step"] == 7 and data["epoch"] == 1
    assert Heartbeat.age(path) < 5.0


def test_heartbeat_dead_process_detection(tmp_path):
    live = Heartbeat(str(tmp_path / "p0.heartbeat"))
    live.beat(step=1)
    # a stale heartbeat: write then backdate its ts
    stale_path = str(tmp_path / "p1.heartbeat")
    Heartbeat(stale_path, process_index=1).beat(step=0)
    with open(stale_path) as f:
        payload = json.load(f)
    payload["ts"] = time.time() - 1000
    with open(stale_path, "w") as f:
        json.dump(payload, f)

    dead = Heartbeat.dead_processes(str(tmp_path), timeout=60)
    assert dead == [stale_path]


# -- HealthMonitor -----------------------------------------------------------

def test_monitor_nan_loss_raises_immediately():
    mon = HealthMonitor()
    with pytest.raises(TrainingDiverged):
        mon.observe(float("nan"))


def test_monitor_loss_explosion_after_warmup():
    mon = HealthMonitor(explode_factor=10.0, warmup_steps=4)
    for _ in range(6):
        mon.observe(1.0, 0.1)
    with pytest.raises(TrainingDiverged):
        mon.observe(1000.0, 0.1)


def test_monitor_straggler_detection():
    mon = HealthMonitor(straggler_factor=5.0, warmup_steps=4)
    for _ in range(6):
        mon.observe(1.0, 0.1)
    with pytest.raises(StragglerDetected):
        mon.observe(1.0, 10.0)


def test_monitor_tolerates_normal_drift():
    mon = HealthMonitor(warmup_steps=4)
    for i in range(50):
        mon.observe(1.0 + 0.1 * np.sin(i), 0.1 + 0.01 * (i % 3))


# -- device healthcheck ------------------------------------------------------

def test_device_healthcheck_cpu():
    assert device_healthcheck("cpu")
    assert device_healthcheck(torch.device("cpu"))


def test_device_healthcheck_defaults_to_cuda(monkeypatch):
    import inspect

    assert inspect.signature(device_healthcheck).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if not torch.backends.cuda.is_built():  # a CPU build fails to place the probe: unhealthy
        assert not device_healthcheck()
    assert not device_healthcheck("no-such-device")


# -- FaultInjector -----------------------------------------------------------

def test_injector_fires_once():
    inj = FaultInjector(crash_at=[3], nan_loss_at=[5])
    inj.maybe_crash(2)
    with pytest.raises(InjectedFault):
        inj.maybe_crash(3)
    inj.maybe_crash(3)  # second pass over step 3 does not re-fire
    assert np.isnan(inj.corrupt_loss(5, 1.0))
    assert inj.corrupt_loss(5, 1.0) == 1.0


# -- ElasticSupervisor -------------------------------------------------------

def test_supervisor_retries_then_succeeds():
    attempts = []

    def work(attempt):
        attempts.append(attempt)
        if attempt < 2:
            raise RuntimeError("transient")
        return "ok"

    sup = ElasticSupervisor(max_restarts=3, backoff_s=0.0, sleep=lambda s: None)
    assert sup.run(work) == "ok"
    assert attempts == [0, 1, 2]
    assert len(sup.events) == 2


def test_supervisor_gives_up_after_max_restarts():
    sup = ElasticSupervisor(max_restarts=2, backoff_s=0.0, sleep=lambda s: None)
    with pytest.raises(RuntimeError):
        sup.run(lambda a: (_ for _ in ()).throw(RuntimeError("always")))
    assert len(sup.events) == 2


def test_supervisor_fatal_errors_propagate_without_retry():
    calls = []

    def work(attempt):
        calls.append(attempt)
        raise KeyboardInterrupt

    sup = ElasticSupervisor(max_restarts=5, backoff_s=0.0, sleep=lambda s: None)
    with pytest.raises(KeyboardInterrupt):
        sup.run(work)
    assert calls == [0]


def test_supervisor_aborts_on_failed_healthcheck():
    sup = ElasticSupervisor(max_restarts=3, backoff_s=0.0,
                            healthcheck=lambda: False, sleep=lambda s: None)
    with pytest.raises(RuntimeError):
        sup.run(lambda a: (_ for _ in ()).throw(RuntimeError("boom")))
    assert len(sup.events) == 1  # one restart attempted, then aborted


# -- end-to-end: supervised recovery over a real runner ----------------------

def test_supervised_run_recovers_from_injected_crash(tmp_path):
    Logger(None)
    cfg = make_cfg(tmp_path, max_epoch=4)
    injector = FaultInjector(crash_at=[3])  # mid-epoch-1 crash (2 steps/epoch)
    hb = Heartbeat(str(tmp_path / "p0.heartbeat"))

    result = supervised_run(
        lambda attempt: build_runner(cfg, make_loader(), None, None),
        max_restarts=2, injector=injector, heartbeat=hb,
        monitor_factory=lambda: HealthMonitor(warmup_steps=100),
    )
    assert len(result.restarts) == 1
    assert "injected crash" in result.restarts[0].error
    # run completed: resume state marks finished, heartbeat advanced
    state = json.load(open(tmp_path / "resume_state.json"))
    assert state["finished"]
    assert Heartbeat.read(str(tmp_path / "p0.heartbeat"))["step"] >= 6


def test_supervised_run_recovers_from_nan_loss(tmp_path):
    Logger(None)
    cfg = make_cfg(tmp_path, max_epoch=3)
    injector = FaultInjector(nan_loss_at=[2])

    result = supervised_run(
        lambda attempt: build_runner(cfg, make_loader(), None, None),
        max_restarts=2, injector=injector,
        monitor_factory=lambda: HealthMonitor(),
    )
    assert len(result.restarts) == 1
    assert "TrainingDiverged" in result.restarts[0].error
    assert json.load(open(tmp_path / "resume_state.json"))["finished"]


def test_supervised_run_exhausts_restarts_on_persistent_fault(tmp_path):
    Logger(None)
    cfg = make_cfg(tmp_path, max_epoch=3)
    # crash at every step of epoch 0: attempt 0 and all retries die before
    # the first checkpoint is ever written
    injector = FaultInjector(crash_at=[0])

    def factory(attempt):
        injector._crash_at.add(0)  # re-arm: persistent fault
        return build_runner(cfg, make_loader(), None, None)

    with pytest.raises(InjectedFault):
        supervised_run(factory, max_restarts=2, injector=injector)
