"""The port's calibration and pack on a ``(data, model)`` mesh of gloo ranks
on the CPU (``tests/_torch_mesh.py``), held against JAX's one-device
calibration of the global batch.

TestCNN (8 classes, 16 px, BN folded), a global batch of 8: JAX's
variables after its init pass, then two calibration steps on new global
batches, each rank calibrating on its ``data`` rows
(``qtt.calibrate_model``), at ``(2, 1)``, ``(1, 2)`` and ``(2, 2)``, one
config per observer: MinMax, MAMinMax with momentum, percentile (the
weights per tensor), MSE (the weights per tensor), CrossEntropy on the
head, ACIQ, AWQ, grouped AWQ (``q_group_size`` 8 on ``conv2``, ``fc1`` and
``fc2``, with bias correction, as ``configs/runners/ptq/bias_correct/
awq.yaml``), BiasCorrect and per-tensor MinMax weights (``qat_layer``'s
granularity). For each:

* every rank's calibrated ``qparams`` and ``qobs``, gathered whole, within
  rtol 1e-5 of JAX's (the accepted reassociation class, ROADMAP §3,
  ``tests/test_torch_resnet.py``), the counts exact, and the ranks bit-equal
  to each other;
* ``pack_model`` on the mesh, gathered whole (``gather_variables``), equal
  bit for bit to the port's one-device pack of the gathered calibrated
  variables, and the packed logits of each rank's rows equal bit for bit to
  the one-device packed forward, and within 1e-3 of max|logits| of JAX's
  packed forward over its own pack sharded on its virtual mesh;
* the collectives of a MinMax step: one all-gather a quantizer that reads
  rows split over ``data``, one a layer on a slice.

``test_data_parallel_calibration_reduces_over_the_ranks`` is the repair's
test: before it, a ``(2, 1)`` calibration kept each rank's own rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_mesh import flat_tensors, run_jobs
from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.parallel import make_mesh as jax_make_mesh
from quantize_tpu.parallel import shard_variables as jax_shard_variables
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert

torch.set_num_threads(2)

MESHES = [(2, 1), (1, 2), (2, 2)]
LAYERS = ["conv1", "conv2", "fc1", "fc2"]
N, SIZE, CLASSES = 8, 16, 8


def _cfg(act=None, weight=None, **default):
    w = {"n_bits": 8, "symmetric": True, "granularity": "channel", "range": {"name": "minmax"}}
    a = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}
    return {"default": {"weight": {**w, **(weight or {})}, "activation": {**a, **(act or {})},
                        "bn_folding": True, **default}}


CONFIGS = {
    "minmax": _cfg(),
    "maminmax": _cfg(act={"range": {"name": "maminmax", "momentum": 0.1}}),
    "percentile": _cfg(act={"range": {"name": "minmax", "percentile": 0.05}},
                       weight={"granularity": "layer",
                               "range": {"name": "minmax", "percentile": 0.05}}),
    "mse": _cfg(act={"range": {"name": "mse"}},
                weight={"granularity": "layer", "range": {"name": "mse"}}),
    "cross_entropy": {**_cfg(), "/fc2": {"activation": {
        "n_bits": 8, "symmetric": False, "granularity": "layer",
        "range": {"name": "cross_entropy", "maxshrink": 0.8, "grid": 100}}}},
    "aciq": _cfg(act={"range": {"name": "aciq"}}),
    "awq": _cfg(weight={"range": {"name": "awq"}}),
    # conv1's 27 flattened in-features hold no group of 8
    "awq_grouped": {**_cfg(bias_correct=True), **{
        f"/{layer}": {"weight": {"range": {"name": "awq", "q_group_size": 8}}}
        for layer in ("conv2", "fc1", "fc2")}},
    "bias_correct": _cfg(bias_correct=True),
    "qat_layer": _cfg(weight={"granularity": "layer"}),
}


def _batches():
    rng = np.random.default_rng(24)
    return [rng.normal(size=(N, SIZE, SIZE, 3)).astype(np.float32) for _ in range(4)]


def _jax_case(cfg, batches):
    """JAX's variables after init (on the first batch), after two more
    calibration steps, its pack (on the last batch) and its packed logits
    of the last batch on each mesh."""
    init_x, steps, x = batches[0], batches[1:3], batches[3]
    model = JAX_MODELS.build("testcnn", num_classes=CLASSES, ctx=JaxQuantCtx(cfg))
    v = dict(model.init(jax.random.PRNGKey(0), jnp.asarray(init_x), mode="calibrate"))
    v.pop("taps", None)
    init = jax.device_get(v)
    for xb in steps:
        _, upd = model.apply(v, jnp.asarray(xb), mode="calibrate", mutable=["qobs", "qparams"])
        v = {**v, **upd}
    deploy = jax_pack_model(model, v, jnp.asarray(x))
    fwd = jax.jit(lambda d, img: model.apply(d, img, mode="packed"))
    logits = {}
    for dp, tp in MESHES:
        mesh = jax_make_mesh(dp=dp, tp=tp)
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None, None, None)))
        logits[dp, tp] = np.asarray(fwd(jax_shard_variables(mesh, deploy), xs))
    return init, jax.device_get(v), logits


def _name(cfg, mesh):
    return f"{cfg}_{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """JAX's side by config, and every job's reports and saved results on
    2 ranks and on 4."""
    tmp = tmp_path_factory.mktemp("mesh_calibrate")
    batches = _batches()
    paths = []
    for i, xb in enumerate(batches):
        np.save(tmp / f"x{i}.npy", xb)
        paths.append(str(tmp / f"x{i}.npy"))
    jax_side, jobs = {}, {2: [], 4: []}
    for cfg_name, cfg in CONFIGS.items():
        init, final, logits = _jax_case(cfg, batches)
        jax_side[cfg_name] = (final, logits)
        torch.save(flat_tensors(init), tmp / f"{cfg_name}.pt")
        for mesh in MESHES:
            jobs[mesh[0] * mesh[1]].append({
                "name": _name(cfg_name, mesh), "mesh": list(mesh),
                "build": {"name": "testcnn", "kw": {"num_classes": CLASSES}}, "cfg": cfg,
                "variables": str(tmp / f"{cfg_name}.pt"), "x": paths[3],
                "calibrate": paths[1:3], "pack": paths[3],
                "out": str(tmp / _name(cfg_name, mesh))})
    ranks = {world: run_jobs(world, j, tmp) for world, j in jobs.items()}
    return jax_side, ranks, batches


def _ranks(cases, cfg, mesh):
    world = mesh[0] * mesh[1]
    reports, saved = cases[1][world]
    name = _name(cfg, mesh)
    return [reports[r][name] for r in range(world)], [saved[r][name] for r in range(world)]


def _rows(mesh, rank):
    n = N // mesh[0]
    i = rank // mesh[1]
    return slice(i * n, (i + 1) * n)


def _check_against_jax(got: dict, want: dict, tag: str) -> None:
    for col in ("qparams", "qobs"):
        theirs = {f"{col}/{k}": a for k, a in convert.flatten(want[col]).items()}
        mine = {k: t for k, t in got.items() if k.startswith(col + "/")}
        assert set(mine) == set(theirs), f"{tag}: {sorted(set(mine) ^ set(theirs))}"
        for key, val in theirs.items():
            if key.endswith("count"):
                np.testing.assert_array_equal(mine[key].numpy(), val, err_msg=f"{tag} {key}")
            else:
                np.testing.assert_allclose(mine[key].numpy(), val, rtol=1e-5, atol=1e-7,
                                           err_msg=f"{tag} {key}")


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_calibration_matches_jax_on_the_global_batch(cases, cfg, mesh):
    _, saved = _ranks(cases, cfg, mesh)
    for rank, got in enumerate(saved):
        _check_against_jax(got["calibrated"], cases[0][cfg][0], f"{cfg} {mesh} rank {rank}")
    for rank, got in enumerate(saved[1:], 1):  # every rank holds the same bits
        assert _same(got["calibrated"], saved[0]["calibrated"]), f"rank {rank}"


def _one_device(cases, cfg, mesh):
    """The port's one-device pack of the mesh's gathered calibrated
    variables (on the whole pack batch), and its packed logits."""
    _, saved = _ranks(cases, cfg, mesh)
    flat = saved[0]["calibrated"]
    tree = {}
    for key, t in flat.items():
        col, rest = key.split("/", 1)
        tree.setdefault(col, {})[rest] = t
    model = qtt.MODELS.build("testcnn", num_classes=CLASSES, ctx=qtt.QuantCtx(CONFIGS[cfg]),
                             device="cpu")
    convert.from_jax_variables(model, tree)
    x = torch.from_numpy(cases[2][3])
    deploy = qtt.pack_model(model, x, device="cpu")
    with torch.no_grad():
        logits = model(x, mode="packed")
    return {f"{c}/{k}": t for c, f in deploy.items() for k, t in f.items()}, logits


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_pack_on_the_mesh_matches_one_device(cases, cfg, mesh):
    reports, saved = _ranks(cases, cfg, mesh)
    deploy, logits = _one_device(cases, cfg, mesh)
    want_jax = cases[0][cfg][1][mesh]
    for rank, got in enumerate(saved):
        assert _same(got["deploy"], deploy), f"rank {rank}: {sorted(got['deploy'])[:4]}"
        assert reports[rank]["pack_sharded"] == (mesh[1] > 1)
        rows = _rows(mesh, rank)
        assert torch.equal(got["packed"], logits[rows]), f"rank {rank}"
        want = want_jax[rows]
        assert np.max(np.abs(got["packed"].numpy() - want)) <= 1e-3 * np.max(np.abs(want))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_minmax_step_collectives(cases, mesh):
    reports, _ = _ranks(cases, "minmax", mesh)
    dp, tp = mesh
    # each activation quantizer reads rows split over data; each split
    # layer gathers its output; per-channel weights on a slice need none
    want = len(LAYERS) * (dp > 1) + len(LAYERS) * (tp > 1)
    for rep in reports:
        assert rep["calibrate"] == {"all-gather": want}
        assert rep["split"] == (LAYERS if tp > 1 else [])


def test_data_parallel_calibration_reduces_over_the_ranks(cases):
    """The repair: at ``(2, 1)`` each rank reads other rows, yet both end
    with the global batch's qparams (before, each kept the range of its own
    rows, and the ranks disagreed with each other and with JAX)."""
    _, saved = _ranks(cases, "minmax", (2, 1))
    steps = cases[2][1:3]
    assert not np.array_equal(steps[0][_rows((2, 1), 0)], steps[0][_rows((2, 1), 1)])
    want = cases[0]["minmax"][0]
    for rank, got in enumerate(saved):
        _check_against_jax(got["calibrated"], want, f"rank {rank}")
        scale = got["calibrated"]["qparams/conv2/a_quantizer/scale"]
        np.testing.assert_allclose(scale.numpy(), want["qparams"]["conv2"]["a_quantizer"]["scale"],
                                   rtol=1e-5)
    assert _same(saved[0]["calibrated"], saved[1]["calibrated"])


def test_awq_refuses_per_tensor_weights():
    """AWQ's weight ranges are per channel (or per group) in both packages,
    so on a slice of the out channels they are the slice's own: a per-tensor
    AWQ weight quantizer is refused before any statistic is taken."""
    cfg = _cfg(weight={"granularity": "layer", "range": {"name": "awq"}})
    x = _batches()[0]
    jax_model = JAX_MODELS.build("testcnn", num_classes=CLASSES, ctx=JaxQuantCtx(cfg))
    with pytest.raises(ValueError, match="channel granularity"):
        jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x), mode="calibrate")
    model = qtt.MODELS.build("testcnn", num_classes=CLASSES, ctx=qtt.QuantCtx(cfg), device="cpu")
    with pytest.raises(ValueError, match="channel granularity"):
        qtt.init_model(model, x, seed=0, device="cpu")
