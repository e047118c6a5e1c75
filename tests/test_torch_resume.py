"""Resumable and supervised runs in the port (``runners/resume.py``), held
against the JAX package on the CPU, on ``tests/test_resume.py``'s config:
the PTQ runner on TestCNN (8 x 8, 4 classes), 64 synthetic images in
batches of 32 (2 steps an epoch).

* An interrupted run resumes at the epoch whose checkpoint was never
  written, runs to ``finished``, and a third invocation is a no-op (JAX's
  ``test_resume_after_interrupt``).
* ``supervised_run`` with a crash injected at step 3 (mid-epoch 1 of 4) and
  with a NaN loss at step 2 (3 epochs): one restart each, with JAX's error,
  the resume state ``finished`` at JAX's epoch cursor, the heartbeat at
  JAX's last step. The port starts from JAX's variables after its init, so
  the final variables compare: params bit-equal (PTQ trains none),
  calibrated qparams and observer state within the runner parity's rtol
  1e-5 (``tests/test_torch_runner.py``), counts equal.
* ``train.elastic`` runs through ``execute_runner(device="cpu")`` on
  ``tests/test_e2e_ptq.py``'s config: a test result, the run ``finished``.
"""
import json

import jax
import numpy as np
import pytest
import torch

import quantize_tpu.parallel.fault as jax_fault
import quantize_tpu.runners as jax_runners
from quantize_tpu.runners.resume import supervised_run as jax_supervised_run
import quantize_tpu_torch.runners as runners
from quantize_tpu_torch import convert
from quantize_tpu_torch.parallel import FaultInjector, HealthMonitor, Heartbeat
from quantize_tpu_torch.runners.resume import ResumableRun, supervised_run
from quantize_tpu_torch.utils import Config, Logger

import test_resume
from test_e2e_ptq import base_cfg
from test_torch_fault import build_runner, make_cfg, make_loader

torch.set_num_threads(2)


def test_resume_after_interrupt(tmp_path):
    Logger(None)
    cfg = make_cfg(tmp_path)
    runner = build_runner(cfg, make_loader(), None, None)

    class Boom(Exception):
        pass

    orig_update = runner.update

    def crashing_update(epoch):
        orig_update(epoch)
        if epoch == 1:
            raise Boom

    runner.update = crashing_update
    rr = ResumableRun(runner, ckpt_every_epochs=1)
    with pytest.raises(Boom):
        rr.run()
    assert not rr.finished

    runner2 = build_runner(cfg, make_loader(), None, None)
    seen = []
    orig2 = runner2.update
    runner2.update = lambda e: (seen.append(e), orig2(e))
    rr2 = ResumableRun(runner2, ckpt_every_epochs=1)
    rr2.run()
    assert seen == [1, 2, 3]
    assert rr2.finished

    runner3 = build_runner(cfg, make_loader(), None, None)
    runner3.update = lambda e: pytest.fail("a finished run must not train again")
    ResumableRun(runner3).run()


# name: (max_epoch, FaultInjector keywords, monitor keywords, the restart's error)
INJECTIONS = {"crash": (4, {"crash_at": [3]}, {"warmup_steps": 100}, "injected crash"),
              "nan_loss": (3, {"nan_loss_at": [2]}, {}, "TrainingDiverged")}


@pytest.fixture(scope="module", params=sorted(INJECTIONS))
def supervised(request, tmp_path_factory):
    max_epoch, inject, monitor, error = INJECTIONS[request.param]
    Logger(None)
    out = {"error": error}
    v0 = {}
    for side in ("jax", "port"):
        d = tmp_path_factory.mktemp(side)
        hb = str(d / "p0.heartbeat")
        if side == "jax":
            def factory(attempt):
                runner = jax_runners.build_runner(test_resume.make_cfg(d, max_epoch),
                                                  test_resume.make_loader(), None, None)
                init = runner.init_variables

                def init_and_keep(batch, seed=0):
                    init(batch, seed)
                    v0.setdefault("variables", jax.device_get(runner.variables))

                runner.init_variables = init_and_keep
                return runner

            result = jax_supervised_run(
                factory, max_restarts=2, injector=jax_fault.FaultInjector(**inject),
                heartbeat=jax_fault.Heartbeat(hb),
                monitor_factory=lambda: jax_fault.HealthMonitor(**monitor))
            final = jax.device_get(result.runner.variables)
        else:
            def factory(attempt):
                runner = build_runner(make_cfg(d, max_epoch), make_loader(), None, None)
                if attempt == 0:  # JAX's variables after its init
                    runner.variables = v0["variables"]
                return runner

            result = supervised_run(
                factory, max_restarts=2, injector=FaultInjector(**inject),
                heartbeat=Heartbeat(hb), monitor_factory=lambda: HealthMonitor(**monitor))
            final = convert.to_numpy(result.runner.model)
        out[side] = {"restarts": [(e.attempt, e.error) for e in result.restarts],
                     "state": json.load(open(d / "resume_state.json")),
                     "beat": Heartbeat.read(hb), "final": final}
    return out


def test_supervised_run_restarts_as_jax(supervised):
    mine, theirs = supervised["port"], supervised["jax"]
    assert len(mine["restarts"]) == len(theirs["restarts"]) == 1
    assert supervised["error"] in mine["restarts"][0][1]
    assert mine["restarts"] == theirs["restarts"]
    for side in (mine, theirs):
        assert side["state"]["finished"]
    assert mine["state"]["epoch"] == theirs["state"]["epoch"]
    assert mine["state"]["checkpoint"].endswith("ckpt_resume.pkl")
    assert {k: mine["beat"][k] for k in ("step", "epoch")} == \
        {k: theirs["beat"][k] for k in ("step", "epoch")}


def test_supervised_run_final_variables_match_jax(supervised):
    mine, theirs = supervised["port"]["final"], supervised["jax"]["final"]
    assert {"params", "qparams", "qobs"} <= set(mine) and set(mine) == set(theirs)
    for col in sorted(theirs):
        m, t = convert.flatten(mine[col]), convert.flatten(theirs[col])
        assert set(m) == set(t), col
        for key, val in t.items():
            if col == "params" or key.endswith("count"):
                np.testing.assert_array_equal(m[key], val, err_msg=f"{col}/{key}")
            else:
                np.testing.assert_allclose(m[key], val, rtol=1e-5, atol=1e-7,
                                           err_msg=f"{col}/{key}")


def test_elastic_run_through_execute_runner(tmp_path):
    Logger(None)
    cfg = Config(base_cfg(tmp_path, train_extra={
        "max_epoch": 2, "elastic": {"max_restarts": 1, "monitor": True}}).to_dict())
    result = runners.execute_runner(cfg, device="cpu")
    assert result["n"] == 128 and 0.0 <= result["top1"] <= 100.0
    state = json.load(open(tmp_path / "resume_state.json"))
    assert state["finished"] and state["epoch"] == 1
    assert Heartbeat.read(str(tmp_path / "p0.heartbeat"))["step"] == 7
