"""The port's serving engine on a tensor-parallel mesh, and the PTQ runner on
a data-parallel one, as gloo ranks on the CPU (``tests/_torch_mesh.py``).

* The engine (``parallel/serving.InferenceEngine``) on ``(1, 2)`` and
  ``(2, 2)`` over TestCNN W8A8 packed by the JAX package (``tests/
  test_torch_serving.py``'s), loaded with ``shard_variables``: each
  ``model`` group's leader serves the images of its ``data`` rows, its
  followers run the same batches; the results equal the port's one-device
  packed forward bit for bit and JAX's engine on ``make_mesh(dp=4, tp=2)``
  within 1e-3 of max|logits| (``test_torch_serving.assert_close_to_jax``'s
  criterion). A follower's ``submit`` raises; the leader's ``stop()`` ends
  its followers' loops; a follower whose own packed carry dtype differs
  serves under the leader's (the results still bit-equal); a follower
  whose leader stays silent raises from ``stop()`` within its timeout
  instead of hanging.
* The PTQ runner through ``execute_runner`` on ``(2, 1)`` (TestCNN,
  synthetic data, ``ptq_rn18_w8a8_synthetic.yaml``), each rank calibrating
  on its half of every batch: the one-device run's test top-1 and example
  count, and its checkpoint's qparams within rtol 1e-5 (rank 0 writes the
  variables gathered whole).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh import flat_tensors, run_jobs
from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.parallel import make_mesh as jax_make_mesh
from quantize_tpu.parallel.serving import InferenceEngine as JaxEngine
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert

torch.set_num_threads(2)

W8A8 = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}
CLASSES, IMAGES, BATCH = 4, 24, 4
RUNNER_CFG = "configs/runners/ptq/minmax/ptq_rn18_w8a8_synthetic.yaml"
RUNNER_OPTS = ["train.print_freq=100"]
SILENT_TIMEOUT_S = 2.0


@pytest.fixture(scope="module")
def packed():
    model = JAX_MODELS.build("testcnn", num_classes=CLASSES, ctx=JaxQuantCtx(W8A8))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4, 16, 16, 3)).astype(np.float32))
    variables = dict(model.init(jax.random.PRNGKey(0), x, mode="calibrate"))
    variables.pop("taps", None)
    _, upd = model.apply(variables, x, mode="calibrate", mutable=["qobs", "qparams"])
    deploy = jax.device_get(jax_pack_model(model, {**variables, **upd}, x))
    images = np.random.default_rng(7).normal(size=(IMAGES, 16, 16, 3)).astype(np.float32)
    return model, deploy, images


def _runner_cfg(out_dir):
    import argparse

    from quantize_tpu_torch.cli import setup_cfg

    return setup_cfg(argparse.Namespace(cfg=[RUNNER_CFG], output_dir=str(out_dir),
                                        opts=RUNNER_OPTS))


@pytest.fixture(scope="module")
def ranks(packed, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_engine")
    torch.save(flat_tensors(packed[1]), tmp / "deploy.pt")
    np.save(tmp / "x.npy", packed[2])

    def job(name, mesh, **what):
        return {"name": name, "mesh": list(mesh),
                "build": {"name": "testcnn", "kw": {"num_classes": CLASSES}}, "cfg": W8A8,
                "variables": str(tmp / "deploy.pt"), "x": str(tmp / "x.npy"),
                "out": str(tmp / name), **what}

    two = [job("engine1x2", (1, 2), engine={"batch": BATCH}),
           job("switches1x2", (1, 2), engine={"batch": BATCH, "follower_carry": "bfloat16"}),
           {"name": "runner2x1", "mesh": [2, 1], "out": str(tmp / "runner2x1"),
            "runner": {"cfg": [RUNNER_CFG], "output_dir": str(tmp / "runner_mesh"),
                       "opts": RUNNER_OPTS}},
           # last: the follower's timed-out wait ends this spawn's use of the group
           job("silent1x2", (1, 2), engine={"batch": BATCH, "silent": True,
                                            "follow_timeout_s": SILENT_TIMEOUT_S})]
    four = [job("engine2x2", (2, 2), engine={"batch": BATCH})]
    return {2: run_jobs(2, two, tmp), 4: run_jobs(4, four, tmp)}, tmp


def _one_device(packed):
    model = qtt.MODELS.build("testcnn", num_classes=CLASSES, ctx=qtt.QuantCtx(W8A8),
                             device="cpu")
    convert.from_jax_variables(model, packed[1])
    with torch.inference_mode():
        return model(torch.from_numpy(packed[2]), mode="packed").numpy()


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_engine_on_a_tensor_parallel_mesh(packed, ranks, mesh):
    dp, tp = mesh
    reports, saved = ranks[0][dp * tp]
    name = f"engine{dp}x{tp}"
    want = _one_device(packed)
    model, deploy, images = packed
    with JaxEngine(model, deploy, batch_size=8, mesh=jax_make_mesh(dp=4, tp=2)) as eng:
        jax_out = np.stack([f.result(timeout=60) for f in eng.submit_many(list(images))])
    n = IMAGES // dp
    for rank in range(dp * tp):
        rep = reports[rank][name]
        assert rep["leader"] == (rank % tp == 0)
        rows = slice((rank // tp) * n, (rank // tp + 1) * n)
        leader = reports[rank - rank % tp][name]["engine"]
        if rep["leader"]:
            got = saved[rank][name]["served"].numpy()
            np.testing.assert_array_equal(got, want[rows])
            assert np.max(np.abs(got - jax_out[rows])) <= 1e-3 * np.max(np.abs(jax_out[rows]))
            assert rep["engine"]["processed"] == n and rep["engine"]["failed"] == 0
            # a header and the rows a batch; one all-gather a split layer
            batches = rep["engine"]["batches"]
            assert rep["engine"]["counts"]["broadcast"] >= 2 * batches
            assert rep["engine"]["counts"]["all-gather"] == 4 * batches
        else:
            assert "leader" in rep["submit_error"]
            # the leader stopped, so the follower's loop ended, after the
            # same batches
            assert rep["engine"]["batches"] == leader["batches"]
            assert rep["engine"]["processed"] == leader["processed"]


def test_a_follower_serves_under_its_leaders_switches(packed, ranks):
    reports, saved = ranks[0][2]
    leader, follower = reports[0]["switches1x2"], reports[1]["switches1x2"]
    assert leader["leader"] and not follower["leader"]
    np.testing.assert_array_equal(saved[0]["switches1x2"]["served"].numpy(),
                                  _one_device(packed)[:IMAGES])
    assert leader["engine"]["failed"] == 0
    assert follower["engine"]["batches"] == leader["engine"]["batches"]
    # the follower's own switch is back once the batches are done
    assert follower["follower_carry"] == "torch.bfloat16"


def test_a_silent_leader_fails_its_follower(ranks):
    reports, _ = ranks[0][2]
    follower = reports[1]["silent1x2"]
    assert reports[0]["silent1x2"]["leader"] and not follower["leader"]
    assert "failed or went silent" in follower["follower_error"]
    assert follower["follower_s"] < SILENT_TIMEOUT_S + 30


def test_ptq_runner_on_a_data_parallel_mesh(ranks):
    from quantize_tpu_torch.runners import execute_runner
    from quantize_tpu_torch.utils import set_random_seed

    reports, _ = ranks[0][2]
    tmp = ranks[1]
    cfg = _runner_cfg(tmp / "runner_one")
    set_random_seed(cfg.seed)
    want = execute_runner(cfg, device="cpu")
    for rank in range(2):
        got = reports[rank]["runner2x1"]["runner"]
        assert got["n"] == want["n"] and got["top1"] == want["top1"], (got, want)
    mesh_ckpt = torch.load(tmp / "runner_mesh" / "ckpt_last.pkl", weights_only=True)
    one_ckpt = torch.load(tmp / "runner_one" / "ckpt_last.pkl", weights_only=True)
    mine = convert.flatten(mesh_ckpt["variables"]["qparams"])
    theirs = convert.flatten(one_ckpt["variables"]["qparams"])
    assert set(mine) == set(theirs)
    for key, t in theirs.items():
        np.testing.assert_allclose(mine[key].numpy(), t.numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
