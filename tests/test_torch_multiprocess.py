"""Multi-device packed inference across processes on the CPU: ranks spawned
as fresh interpreters, joined over ``torch.distributed`` on gloo at a free
port on 127.0.0.1, one rank a process, every spawn under a timeout
(``quantize_tpu_torch.parallel.scaling.spawn_ranks``).

* The port's one-device packed TestCNN W8A8, given JAX's deploy variables
  through ``convert.from_jax_variables``, equals JAX's eager
  ``model.apply(..., mode="packed")`` bit for bit.
* Tensor parallelism over two ranks (``make_mesh(1, 2)``,
  ``shard_variables``): that TestCNN (so its ranks equal JAX), ResNet-18
  and ResNet-50 (every conv and the head on its slice of the out channels;
  ResNet-50 with the fused residual tail, K2 given its residual's slice,
  and under the int8 carry), a 2-layer ViT at W8A8 (the MLP split; the attention
  block, whose kernels read the fused q/k/v, whole) and at W4A8 (K4's
  split-half int4 weights: whole, their shards gathered at load), and a
  narrow MobileNetV2 (depthwise convs whole): each rank's logits, from its
  rows assembled by ``shard_batch_to_mesh`` out of each process's
  ``host_slice``, equal the one-device forward's bit for bit (the plain
  versions), and the gathers are counted.
* ``run_multiprocess_scaling``: pure data parallelism counts no collective;
  ``(1, 2)`` counts all-gathers with bytes; ``(1, 4)`` counts no fewer than
  ``(2, 2)`` (JAX's ``test_measure_scaling_census_by_mesh_shape``), four
  ranks each; every rank's rows bit-equal to the one-device forward.
* A failing or hung worker is killed, and the error carries its output.
"""
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.models.vit import VisionTransformer
from quantize_tpu_torch.parallel import run_multiprocess_scaling
from quantize_tpu_torch.parallel.scaling import spawn_ranks

torch.set_num_threads(2)
TIMEOUT = 240.0

ACT = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}


def _cfg(bits):
    return {"default": {"weight": {"n_bits": bits, "symmetric": True, "signed": True,
                                   "granularity": "channel", "range": {"name": "minmax"}},
                        "activation": ACT, "bn_folding": True}}


VIT = dict(num_classes=5, image_size=32, patch_size=8, num_layers=2, num_heads=2,
           hidden_dim=48, mlp_dim=96)
RESNET50 = {"registry": "resnet50", "kw": {"num_classes": 10}}
# name: (how the worker builds it, quant bits, image size, the precision
# switch its forward runs under)
ZOO = {
    "testcnn": ({"registry": "testcnn", "kw": {"num_classes": 10}}, 8, 16, None),
    "resnet18": ({"registry": "resnet18", "kw": {"num_classes": 10}}, 8, 16, None),
    # K2 with its residual cut to the slice's channels
    "resnet50_fused": (RESNET50, 8, 16, "fused_residual"),
    # the int8 carry: conv1 returns its int8 input, whole on every rank
    "resnet50_carry": (RESNET50, 8, 16, "qin_carry"),
    "vit_w8a8": ({"vit": VIT}, 8, 32, None),
    "vit_w4a8": ({"vit": VIT}, 4, 32, None),
    "mobilenet_v2": ({"registry": "mobilenet_v2",
                      "kw": {"num_classes": 10, "width_mult": 0.25}}, 8, 32, None),
}

# one rank: load each model's one-device deploy variables sharded over a
# (1, world) mesh, run the packed forward, save the logits, report counts
WORKER = r"""
import contextlib, json, sys
import numpy as np, torch
import quantize_tpu_torch as qtt
from quantize_tpu_torch.convert import from_jax_variables
from quantize_tpu_torch.models.vit import VisionTransformer
from quantize_tpu_torch.parallel import (CollectiveCounter, host_slice, init_distributed,
                                         make_mesh, shard_batch_to_mesh, shard_variables)
rank, world, port = (int(a) for a in sys.argv[1:4])
jobs = json.loads(sys.argv[4])
init_distributed(rank, world, port)
mesh = make_mesh(1, world, devices=["cpu"] * world)
report = {}
for name, job in jobs.items():
    ctx = qtt.QuantCtx(job["cfg"])
    build = job["build"]
    if "vit" in build:
        model = VisionTransformer(ctx=ctx, device="cpu", **build["vit"])
    else:
        model = qtt.MODELS.build(build["registry"], ctx=ctx, device="cpu", **build["kw"])
    deploy = torch.load(job["deploy"], weights_only=True)
    with CollectiveCounter() as load:
        from_jax_variables(model, shard_variables(mesh, deploy))
    # this process's slice of the batch, assembled into the rank's rows
    # (all of them: one data row) across the model group
    x = shard_batch_to_mesh(mesh, host_slice({"img": np.load(job["x"])}))["img"]
    switch = getattr(qtt, job["switch"])(True) if job["switch"] else contextlib.nullcontext()
    with CollectiveCounter() as fwd, torch.inference_mode(), switch:
        out = model(x, mode="packed")
    np.save(job["out"] + f".rank{rank}.npy", out.float().numpy())
    report[name] = {"load": load.counts, "fwd": fwd.counts, "bytes": fwd.nbytes,
                    "split": sum(getattr(m, "tp_shard", None) is not None
                                 for m in model.modules()),
                    "layers": sum(hasattr(m, "tp_shard") for m in model.modules())}
torch.distributed.destroy_process_group()
print("REPORT " + json.dumps(report), flush=True)
"""


def _port_model(build, bits):
    ctx = qtt.QuantCtx(_cfg(bits))
    if "vit" in build:
        return VisionTransformer(ctx=ctx, device="cpu", **build["vit"])
    return qtt.MODELS.build(build["registry"], ctx=ctx, device="cpu", **build["kw"])


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_testcnn():
    """JAX's packed TestCNN W8A8 at 16 px: its deploy variables (numpy), a
    batch and its eager packed logits."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    jm = JAX_MODELS.build("testcnn", num_classes=10, ctx=JaxQuantCtx(_cfg(8)))
    v = dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mode="calibrate"))
    v.pop("taps", None)
    _, upd = jm.apply(v, jnp.asarray(x), mode="calibrate", mutable=["qobs", "qparams"])
    deploy = jax.device_get(jax_pack_model(jm, {**v, **upd}, jnp.asarray(x)))
    xt = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    return deploy, xt, np.asarray(jm.apply(deploy, jnp.asarray(xt), mode="packed"))


def test_one_device_packed_equals_jax(jax_testcnn):
    deploy, x, want = jax_testcnn
    tm = _port_model(ZOO["testcnn"][0], 8)
    convert.from_jax_variables(tm, deploy)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), mode="packed").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def sharded_zoo(jax_testcnn, tmp_path_factory):
    """Each ZOO model's one-device logits (the port's; TestCNN from JAX's
    deploy variables, and JAX's logits) and two ranks' logits and counts,
    ``(1, 2)``."""
    tmp = tmp_path_factory.mktemp("zoo")
    jobs, one_device, packed = {}, {}, {}
    rng = np.random.default_rng(1)
    for name, (build, bits, size, switch) in ZOO.items():
        key = json.dumps([build, bits])
        if name == "testcnn":
            model = _port_model(build, bits)
            deploy, x, want = jax_testcnn
            deploy = _tensors(deploy)
            convert.from_jax_variables(model, deploy)
        elif key in packed:
            model, deploy, x = packed[key]
        else:
            model = _port_model(build, bits)
            x_cal = rng.normal(size=(4, size, size, 3)).astype(np.float32)
            qtt.init_model(model, x_cal, seed=0, device="cpu")
            deploy = qtt.pack_model(model, x_cal, device="cpu")
            x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
            packed[key] = model, deploy, x
        on = getattr(qtt, switch)(True) if switch else contextlib.nullcontext()
        with torch.inference_mode(), on:
            one_device[name] = model(torch.from_numpy(x), mode="packed").float().numpy()
        if name == "testcnn":
            np.testing.assert_array_equal(one_device[name], want)
        torch.save(deploy, tmp / f"{name}.pt")
        np.save(tmp / f"{name}.x.npy", x)
        jobs[name] = {"build": build, "cfg": _cfg(bits), "deploy": str(tmp / f"{name}.pt"),
                      "x": str(tmp / f"{name}.x.npy"), "out": str(tmp / name),
                      "switch": switch}
    outs = spawn_ranks(2, WORKER, [json.dumps(jobs)], timeout=TIMEOUT, threads=2)
    reports = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("REPORT "))[7:])
               for out in outs]
    logits = {name: [np.load(tmp / f"{name}.rank{r}.npy") for r in range(2)] for name in ZOO}
    return one_device, logits, reports


@pytest.mark.parametrize("name", sorted(ZOO))
def test_tensor_parallel_logits_equal_one_device(sharded_zoo, name):
    one_device, logits, reports = sharded_zoo
    for rank in range(2):
        np.testing.assert_array_equal(logits[name][rank], one_device[name],
                                      err_msg=f"{name} rank {rank}")
    counts = [r[name] for r in reports]
    assert counts[0] == counts[1]  # the ranks run the same collectives
    rep = counts[0]
    if rep["split"]:
        # each layer on a slice gathers its output once a forward
        assert rep["fwd"] == {"all-gather": rep["split"]} and rep["bytes"] > 0
    else:
        assert rep["fwd"] == {}


def test_which_layers_split(sharded_zoo):
    _, _, reports = sharded_zoo
    rep = reports[0]
    # ResNets: every conv (K3, K2) and the head (K1) on its slice
    assert rep["resnet18"]["split"] == rep["resnet18"]["layers"] == 21
    assert rep["resnet50_fused"]["split"] == rep["resnet50_carry"]["split"] == 54
    # the W8A8 ViT: the patch embedding and the MLP's two dense layers a
    # block split; the attention projections whole, and the head (5
    # classes do not split in two: JAX's rules replicate it)
    assert rep["vit_w8a8"]["split"] == 1 + 2 * VIT["num_layers"]
    # the W4A8 ViT: only the patch embedding (Ci = 3, int8) splits; its
    # split-half int4 dense layers gather their shards whole at load
    assert rep["vit_w4a8"]["split"] == 1
    assert rep["vit_w4a8"]["load"]["all-gather"] > rep["vit_w8a8"]["load"].get("all-gather", 0)
    # MobileNetV2: the depthwise convs whole, the rest split
    mb = rep["mobilenet_v2"]
    assert 0 < mb["split"] < mb["layers"]


def test_pure_data_parallel_counts_no_collective():
    r = run_multiprocess_scaling(2, dp=2, tp=1, model_name="resnet18", image_size=16,
                                 timeout=TIMEOUT, device="cpu")
    assert r["mesh"] == {"data": 2, "model": 1} and r["n_processes"] == 2
    assert r["global_batch"] == 4 and r["ranks_per_device"] == 2
    assert r["collective_counts"] == {} and r["collective_bytes_per_step"] == 0
    assert r["n_differ_vs_1dev"] == 0 and r["max_abs_err_vs_1dev"] == 0
    assert np.isfinite(r["weak_scaling_efficiency"]) and r["weak_scaling_efficiency"] > 0


def test_tensor_parallel_counts_all_gathers():
    r = run_multiprocess_scaling(2, dp=1, tp=2, model_name="resnet18", image_size=16,
                                 timeout=TIMEOUT, device="cpu")
    assert r["mesh"] == {"data": 1, "model": 2} and r["platform"] == "cpu"
    assert r["collective_counts"]["all-gather"] >= 1 and r["collective_bytes_per_step"] > 0
    assert r["staged_bytes_per_step"] == 0  # CPU tensors: nothing staged
    assert r["n_differ_vs_1dev"] == 0 and r["max_abs_err_vs_1dev"] == 0


def test_census_by_mesh_shape():
    """More model parallelism does not shrink the collective count; every
    rank's rows equal the one-device forward's."""
    r_tp = run_multiprocess_scaling(4, dp=1, tp=4, model_name="resnet18", image_size=16,
                                    timeout=TIMEOUT, device="cpu")
    r_mix = run_multiprocess_scaling(4, dp=2, tp=2, model_name="resnet18", image_size=16,
                                     timeout=TIMEOUT, device="cpu")
    assert sum(r_tp["collective_counts"].values()) > 0
    assert (sum(r_tp["collective_counts"].values())
            >= sum(r_mix["collective_counts"].values()) > 0)
    assert r_mix["global_batch"] == 4 and r_tp["global_batch"] == 2
    assert r_tp["n_differ_vs_1dev"] == r_mix["n_differ_vs_1dev"] == 0


def test_a_failing_worker_raises_with_its_output():
    with pytest.raises(RuntimeError, match=r"(?s)worker 0 of 2 failed.*no_such_model"):
        run_multiprocess_scaling(2, model_name="no_such_model", timeout=TIMEOUT, device="cpu")


def test_a_hung_worker_is_killed():
    script = "import sys, time; print('rank', sys.argv[1], flush=True); time.sleep(120)"
    with pytest.raises(RuntimeError, match=r"(?s)workers \[0, 1\] of 2 did not finish within "
                                           r"2.0 s.*rank 0"):
        spawn_ranks(2, script, timeout=2.0)
