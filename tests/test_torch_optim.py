"""The port's optimizers and schedules (quantize_tpu_torch.optim) held
against optax, as the JAX package builds them (quantize_tpu.optim), on the
CPU.

* Every schedule's value at every count of a 20-step run, within rtol 1e-6
  (XLA's float32 power of a float exponent may differ from the port's by an
  ulp), and ``multistep``'s reading at milestones {3, 6}.
* 20 steps of every optimizer (sgd with momentum and weight decay, with
  nesterov, plain; adam; adamw; rmsprop with momentum, and with a large
  eps) under every schedule,
  both packages from the same parameters, each step's gradient computed
  from the package's own parameters: the parameters within rtol 1e-6 plus
  1e-6 of the farthest any parameter of the tensor moved (a parameter that
  crossed 0 is small beside the updates that moved it, and an ulp of one of
  those weighs more than 1e-6 of it; rmsprop's rsqrt is XLA's own float32
  approximation, an ulp from PyTorch's on about a third of the inputs, and
  momentum carries each such ulp through the run). A case with a large
  ``eps`` (1e-2) tells optax's ``eps`` inside the square root from torch's
  outside it.
* The QAT runner's ``qparams_lr_scale`` split (optax ``multi_transform``
  with a scaled second optimizer on ``qparams``): 20 steps, rtol 1e-6.

optax runs eagerly: under ``jit`` XLA contracts ``g + decay * t`` into one
fused multiply-add, one rounding fewer than the port's two.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_optim_cases import SCHEDULES
from quantize_tpu import optim as jopt
from quantize_tpu_torch import optim as topt

torch.set_num_threads(2)

STEPS, PER_EPOCH = 20, 3
OPTIMIZERS = {
    "sgd-momentum-wd": {"name": "sgd", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-3},
    "sgd-nesterov": {"name": "sgd", "lr": 0.05, "momentum": 0.9, "nesterov": True},
    "sgd": {"name": "sgd", "lr": 0.05},
    "adam": {"name": "adam", "lr": 1e-2},
    "adamw": {"name": "adamw", "lr": 1e-2, "weight_decay": 1e-2},
    "rmsprop-momentum": {"name": "rmsprop", "lr": 1e-2, "momentum": 0.9},
    "rmsprop-eps": {"name": "rmsprop", "lr": 1e-2, "eps": 1e-2},
}


def _cfg(opt, sched_name):
    return SimpleNamespace(optimizer=SimpleNamespace(**opt),
                           lr_scheduler=SimpleNamespace(name=sched_name, **SCHEDULES[sched_name]),
                           train=SimpleNamespace(max_epoch=6))


@pytest.mark.parametrize("sched", list(SCHEDULES))
def test_schedules_match_optax(sched):
    cfg = _cfg({"name": "adam", "lr": 0.01}, sched)
    want = jopt.build_lr_scheduler(cfg, PER_EPOCH)
    got = topt.build_lr_scheduler(cfg, PER_EPOCH)
    for count in range(STEPS + 5):
        w = np.float32(want(jnp.asarray(count, jnp.int32)))
        g = got(count)
        assert isinstance(g, float) and np.float32(g) == g
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f"{sched} at {count}")


def test_multistep_reads_as_piecewise_constant():
    cfg = SimpleNamespace(optimizer=SimpleNamespace(lr=1.0),
                          lr_scheduler=SimpleNamespace(name="multistep", milestones=[3, 6]))
    got = [topt.build_lr_scheduler(cfg, 1)(t) for t in range(9)]
    want = [float(jopt.build_lr_scheduler(cfg, 1)(jnp.asarray(t, jnp.int32))) for t in range(9)]
    assert got == want
    np.testing.assert_allclose(got, [1.0] * 3 + [0.1] * 3 + [0.01] * 3, rtol=1e-6)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"params/conv/kernel": rng.normal(0, 1, (3, 3, 4, 8)).astype(np.float32),
            "params/fc/bias": rng.normal(0, 0.1, (8,)).astype(np.float32),
            "qparams/fc/w_quantizer/scale": rng.uniform(0.01, 0.1, (8,)).astype(np.float32)}


def _grad(p, step, key):
    """A gradient that depends on the parameters and on the step."""
    noise = np.random.default_rng(100 + step).normal(0, 1, p.shape).astype(np.float32)
    return (np.float32(0.5) * p + noise * np.float32(0.1 if "scale" in key else 1.0)).astype(
        np.float32)


def _run_both(jax_tx, port_tx):
    p0 = _params()
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}

    def jstep(params, state, grads):
        updates, state = jax_tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    state = jax_tx.init(pj)
    opt = topt.Optimizer(port_tx, pt)
    for step in range(STEPS):
        gj = {k: jnp.asarray(_grad(np.asarray(v), step, k)) for k, v in pj.items()}
        pj, state = jstep(pj, state, gj)
        opt.step(pt, {k: torch.from_numpy(_grad(v.numpy(), step, k)) for k, v in pt.items()})
    for k in p0:
        moved = np.abs(np.asarray(pj[k]) - p0[k]).max()
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6,
                                   atol=1e-6 * moved, err_msg=k)
        assert not np.array_equal(pt[k].numpy(), p0[k])


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_optimizers_match_optax(opt, sched):
    cfg = _cfg(OPTIMIZERS[opt], sched)
    _run_both(jopt.build_optimizer(cfg, PER_EPOCH), topt.build_optimizer(cfg, PER_EPOCH))


@pytest.mark.parametrize("opt", ["adam", "sgd-momentum-wd"])
def test_qparams_lr_scale_matches_multi_transform(opt):
    """quantize_tpu/runners/qat.py:41-55's split, and the port's runner's."""
    cfg = _cfg(OPTIMIZERS[opt], "cosine")
    labels = {k: "qparams" if k.startswith("qparams/") else "main" for k in _params()}
    jax_tx = optax.multi_transform(
        {"main": jopt.build_optimizer(cfg, PER_EPOCH),
         "qparams": optax.chain(jopt.build_optimizer(cfg, PER_EPOCH), optax.scale(0.1))}, labels)
    port_tx = topt.Partition(
        {"main": topt.build_optimizer(cfg, PER_EPOCH),
         "qparams": topt.Chain(topt.build_optimizer(cfg, PER_EPOCH), topt.Scale(0.1))},
        lambda key: labels[key])
    _run_both(jax_tx, port_tx)
