"""The JAX package's last public names without a counterpart in the port,
each held against JAX's on seeded inputs on the CPU.

* ``LayerQuantCfg.into_scale``: equal to JAX's over every kind of
  ``bn_folding`` value (a bool, None, a mapping with and without the key, a
  frozen mapping).
* ``Quantizer.set_static_scale``: the leaf is float32 and bit-equal to the
  one JAX writes under ``mutable=["qparams"]`` (float64, float32 and Python
  float values); a ``QuantConv`` given a per-channel static scale after
  calibration agrees with JAX's in quant mode within
  ``tests/test_torch_ops.py``'s tolerances (rtol 1e-5, atol 1e-4), its
  export qparams bit-equal; on a ``(1, 2)`` mesh of gloo ranks each rank
  stores its slice of a per-channel value and a scalar whole, and the
  leaves gathered whole are bit-equal to one device's.
* ``BasicRunner.merge_updates`` on that mesh shards the whole variables as
  the setter does (they gather back bit for bit).
* ``BasicRunner.merge_updates``: ``tests/test_e2e_ptq.py``'s loop (each
  batch calibrated from the runner's variables, the updates merged) in
  both packages from the same variables gives qparams within rtol 1e-5
  (float32 calibration sums in another order, ROADMAP §3) and the same
  observer state; the replace semantics (a leaf missing from an updated
  collection dropped, ``taps`` ignored, every other collection kept, none
  before the variables are set) give the same leaves as JAX's.
* ``quant_conv2d_wo(..., compute_dtype=)``: bfloat16 and float32, SAME and
  VALID, strides 1 and 2, grouped and AWQ-grouped (``group_size``), bit-equal
  to JAX's.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.nn.layers import LayerQuantCfg as JCfg
from quantize_tpu.nn.layers import QuantConv as JConv
from quantize_tpu.nn.quantizer import Quantizer as JQuantizer
from quantize_tpu.ops import qconv as jqconv
from quantize_tpu.quant.qspec import QuantSpec as JSpec
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.nn.layers import LayerQuantCfg, QuantConv
from quantize_tpu_torch.nn.quantizer import Quantizer
from quantize_tpu_torch.ops import qconv as tqconv
from quantize_tpu_torch.quant.qspec import QuantSpec

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4  # tests/test_torch_ops.py's quant-mode tolerances
W8 = {"n_bits": 8, "symmetric": True, "granularity": "channel", "range": {"name": "minmax"}}
A8 = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# LayerQuantCfg.into_scale
# ---------------------------------------------------------------------------

BN_FOLDING = {
    "true": True, "false": False, "none": None, "empty": {},
    "key_false": {"into_scale": False}, "key_true": {"into_scale": True},
    "frozen": types.MappingProxyType({"into_scale": True}),
}


@pytest.mark.parametrize("name", BN_FOLDING)
def test_into_scale_matches_jax(name):
    value = BN_FOLDING[name]
    want = JCfg(bn_folding=value).into_scale
    got = LayerQuantCfg(bn_folding=value).into_scale
    assert got is want
    assert got is (name in ("key_true", "frozen"))


# ---------------------------------------------------------------------------
# Quantizer.set_static_scale
# ---------------------------------------------------------------------------

def _jax_static_scale(value):
    spec = JSpec.from_config(W8, "weight", channel_axis=-1)
    q = JQuantizer(spec)
    _, upd = q.apply({}, jnp.asarray(value), method=JQuantizer.set_static_scale,
                     mutable=["qparams"])
    return np.asarray(upd["qparams"]["static_scale"])


@pytest.mark.parametrize("kind", ["float64", "float32", "python_float", "tensor"])
def test_set_static_scale_leaf_matches_jax(kind):
    rng = np.random.default_rng(3)
    base = rng.uniform(0.1, 3.0, size=(12,))  # float64: rounds to float32 on the way
    value = {"float64": base, "float32": base.astype(np.float32),
             "python_float": 1.2345678901234567, "tensor": torch.from_numpy(base)}[kind]
    want = _jax_static_scale(np.asarray(value) if kind == "tensor" else value)
    q = Quantizer(QuantSpec.from_config(W8, "weight", channel_axis=-1), 12, "cpu")
    assert not q.has_var("qparams", "static_scale")
    q.set_static_scale(value)
    got = q.get_var("qparams", "static_scale")
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    q.set_static_scale(2.0)  # an existing leaf is overwritten
    assert float(q.get_var("qparams", "static_scale")) == 2.0


def _conv_case():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 10, 10, 8)).astype(np.float32)
    ss = rng.uniform(0.5, 1.5, size=(16,)).astype(np.float32)
    return x, ss


def test_set_static_scale_quant_conv_matches_jax():
    """A per-channel BN multiplier installed after calibration: JAX's and
    the port's quant-mode outputs and export qparams."""
    x, ss = _conv_case()
    pad = [(1, 1), (1, 1)]
    jcfg = JCfg(weight=W8, activation=A8, bn_folding={"into_scale": True})
    jmod = JConv(features=16, kernel_size=(3, 3), padding=pad, quant=jcfg)
    xj = jnp.asarray(x)
    v = dict(jmod.init(jax.random.PRNGKey(0), xj, mode="calibrate"))
    v.pop("taps", None)
    _, upd = jmod.apply(v, xj, mode="calibrate", mutable=["qobs", "qparams"])
    v = {**v, **upd}
    # the conv's quantizer is a compact submodule: its set_static_scale's
    # leaf, written by a quantizer of the same spec, goes in its place
    qp = jax.device_get(v["qparams"])
    qp["w_quantizer"] = {**qp["w_quantizer"], "static_scale": _jax_static_scale(ss)}
    v = {**v, "qparams": qp}
    want = np.asarray(jmod.apply(v, xj, mode="quant"))

    tcfg = LayerQuantCfg(weight=W8, activation=A8, bn_folding={"into_scale": True})
    assert tcfg.into_scale and jcfg.into_scale
    tmod = QuantConv(8, 16, (3, 3), padding=pad, quant=tcfg, device="cpu")
    convert.from_jax_variables(tmod, {c: jax.device_get(v[c]) for c in v if c != "qparams"})
    jq = jax.device_get(v["qparams"])
    jq["w_quantizer"] = {k: a for k, a in jq["w_quantizer"].items() if k != "static_scale"}
    convert.from_jax_variables(tmod, {"qparams": jq})
    assert not tmod.w_quantizer.has_var("qparams", "static_scale")
    tmod.w_quantizer.set_static_scale(ss)
    mine = convert.flatten(convert.to_numpy(tmod)["qparams"])
    theirs = convert.flatten(jax.device_get(v["qparams"]))
    assert set(mine) == set(theirs)
    for key, val in theirs.items():
        np.testing.assert_array_equal(mine[key], np.asarray(val), err_msg=key)
    with torch.no_grad():
        got = tmod(_t(x), mode="quant").numpy()
        eff, _ = tmod.w_quantizer(tmod.get_var("params", "kernel"), mode="export_qparams")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        eff.numpy(), np.asarray(v["qparams"]["w_quantizer"]["scale"]) * ss)


MESH_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.nn.layers import _QuantLayerBase
from quantize_tpu_torch.nn.variables import var_modules
from quantize_tpu_torch.parallel import (gather_variables, init_distributed, make_mesh,
                                         rank_variables, shard_variables)

rank, world, port = (int(a) for a in sys.argv[1:4])
job = json.load(open(sys.argv[4]))
init_distributed(rank, world, port)
mesh = make_mesh(1, 2, devices=["cpu"] * 2)
model = qtt.MODELS.build("testcnn", num_classes=8, ctx=qtt.QuantCtx(job["cfg"]), device="cpu")
variables = torch.load(job["variables"], weights_only=True)
convert.from_jax_variables(model, shard_variables(mesh, variables))
scales = torch.load(job["scales"], weights_only=True)
own, split = {}, {}
for path, mod in var_modules(model):
    if isinstance(mod, _QuantLayerBase) and path in scales:
        mod.w_quantizer.set_static_scale(scales[path])
        own[path] = mod.w_quantizer.get_var("qparams", "static_scale").clone()
        shard = mod.tp_shard
        split[path] = None if shard is None else torch.tensor([shard.lo, shard.hi])
whole = gather_variables(mesh, rank_variables(model))
x = torch.load(job["x"], weights_only=True)
with torch.no_grad():
    logits = model(x, mode="quant")
# a runner on the mesh given the whole variables through merge_updates
from quantize_tpu_torch.runners import build_runner
from quantize_tpu_torch.utils import Config
cfg = Config()
cfg.merge_from_dict({"model": {"name": "testcnn", "num_classes": 8}, "quant": job["cfg"]})
runner = build_runner(cfg, device="cpu", mesh=mesh)
runner.merge_updates(variables)
merged = gather_variables(mesh, rank_variables(runner.model))
with torch.no_grad():
    merged_logits = runner.model(x, mode="quant")
torch.save({"own": own, "split": split, "qparams": dict(whole["qparams"]), "logits": logits,
            "merged": {c: dict(t) for c, t in merged.items()}, "merged_logits": merged_logits,
            "runner_split": sum(getattr(m, "tp_shard", None) is not None
                                for m in runner.model.modules())},
           job["out"] + f".rank{rank}.pt")
torch.distributed.destroy_process_group()
print("REPORT done", flush=True)
"""


def test_set_static_scale_on_a_model_sharded_mesh(tmp_path):
    """Each rank of a ``(1, 2)`` mesh stores its slice of a per-channel
    value and a scalar whole; gathered whole, the qparams are bit-equal to
    one device's, and the quant-mode logits on the mesh are within rtol
    1e-5, atol 1e-4 of one device's. A runner on the mesh given the whole
    variables through ``merge_updates`` shards them as the setter does: its
    layers run on slices, and gathered whole its variables are the ones it
    was given, its logits within the same tolerance of one device's."""
    from quantize_tpu_torch.nn.layers import _QuantLayerBase
    from quantize_tpu_torch.nn.variables import collections, var_modules
    from quantize_tpu_torch.parallel.scaling import spawn_ranks

    cfg = {"default": {"weight": W8, "activation": A8, "bn_folding": {"into_scale": True}}}
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(4, 16, 16, 3)).astype(np.float32))
    model = qtt.MODELS.build("testcnn", num_classes=8, ctx=qtt.QuantCtx(cfg), device="cpu")
    qtt.init_model(model, x, seed=0, device="cpu")
    layers = {p: m for p, m in var_modules(model) if isinstance(m, _QuantLayerBase)}
    assert {"conv1", "conv2"} <= set(layers)
    scales = {p: torch.from_numpy(rng.uniform(0.5, 1.5, size=(m.features,)).astype(np.float32))
              for p, m in layers.items()}
    scales["conv2"] = torch.tensor(0.75)  # a scalar: whole on every rank
    variables = {c: {k: t.clone() for k, t in f.items()} for c, f in collections(model).items()}
    with torch.no_grad():
        want_merged = model(x, mode="quant")
    torch.save(variables, tmp_path / "v.pt")
    torch.save(scales, tmp_path / "scales.pt")
    torch.save(x, tmp_path / "x.pt")
    job = {"cfg": cfg, "variables": str(tmp_path / "v.pt"), "scales": str(tmp_path / "scales.pt"),
           "x": str(tmp_path / "x.pt"), "out": str(tmp_path / "out")}
    (tmp_path / "job.json").write_text(json.dumps(job))
    spawn_ranks(2, MESH_WORKER, [str(tmp_path / "job.json")], timeout=240.0, threads=1)

    for p, m in layers.items():
        m.w_quantizer.set_static_scale(scales[p])
    one = collections(model)["qparams"]
    with torch.no_grad():
        want = model(x, mode="quant")
    for r in range(2):
        saved = torch.load(tmp_path / f"out.rank{r}.pt", weights_only=True)
        assert saved["split"]["conv1"] is not None  # a 3 x 3 conv runs on its slice
        for p in layers:
            ss, split = scales[p], saved["split"][p]
            expect = ss if split is None or ss.dim() == 0 else ss[int(split[0]):int(split[1])]
            assert torch.equal(saved["own"][p], expect), p
        assert saved["own"]["conv1"].numel() == layers["conv1"].features // 2
        assert saved["own"]["conv2"].dim() == 0
        assert set(saved["qparams"]) == set(one)
        for key, t in one.items():
            assert torch.equal(saved["qparams"][key], t), key
        torch.testing.assert_close(saved["logits"], want, rtol=RTOL, atol=ATOL)
        assert saved["runner_split"] >= 2
        assert {c: set(f) for c, f in saved["merged"].items()} == {
            c: set(f) for c, f in variables.items()}
        for col, flat in variables.items():
            for key, t in flat.items():
                assert torch.equal(saved["merged"][col][key], t), f"{col}/{key}"
        torch.testing.assert_close(saved["merged_logits"], want_merged, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# BasicRunner.merge_updates
# ---------------------------------------------------------------------------

def _cfg_dict(tmp_path):
    """tests/test_e2e_ptq.py's ``base_cfg`` for the PTQ runner."""
    return {
        "seed": 0, "output_dir": str(tmp_path), "model": {"name": "testcnn"},
        "runner": {"name": "ptq"},
        "quant": {"default": {"weight": {**W8, "signed": True},
                              "activation": {"n_bits": 8, "symmetric": False,
                                             "granularity": "layer",
                                             "range": {"name": "maminmax", "momentum": 0.1}},
                              "bn_folding": True}},
        "train": {"max_epoch": 1, "print_freq": 100},
        "train_dataset": {"name": "synthetic", "split": "train", "n": 256, "image_size": 16},
        "val_dataset": {"name": "synthetic", "split": "val", "n": 128, "image_size": 16},
        "test_dataset": {"name": "synthetic", "split": "test", "n": 128, "image_size": 16},
        "train_loader": {"batch_size": 64, "shuffle": True},
        "val_loader": {"batch_size": 64}, "test_loader": {"batch_size": 64},
    }


def _runners(tmp_path):
    """JAX's PTQ runner initialised on the first batch, the port's loaded
    with its variables, and the train batches (JAX's loader's, numpy)."""
    from quantize_tpu.data.base import build_dataloader
    from quantize_tpu.runners import build_runner as jax_build_runner
    from quantize_tpu.utils import Config as JaxConfig
    from quantize_tpu_torch.runners import build_runner
    from quantize_tpu_torch.utils import Config

    d = _cfg_dict(tmp_path)
    jcfg = JaxConfig()
    jcfg.merge_from_dict(d)
    loader = build_dataloader(jcfg, "train")
    jcfg.model.num_classes = loader.dataset.num_classes
    jr = jax_build_runner(jcfg, loader)
    batches = list(loader)
    jr.init_variables(batches[0], seed=0)
    tcfg = Config()
    tcfg.merge_from_dict({**d, "model": {"name": "testcnn",
                                         "num_classes": loader.dataset.num_classes}})
    tr = build_runner(tcfg, None, device="cpu")
    tr.variables = jax.device_get(jr.variables)
    return jr, tr, batches


def _flat(variables):
    return {col: {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
                  for k, v in convert.flatten(tree).items()}
            for col, tree in variables.items()}


def test_merge_updates_replays_the_e2e_calibration_loop(tmp_path):
    """``tests/test_e2e_ptq.py:135-146``: each batch calibrated from the
    runner's variables and the updates merged, in both packages."""
    jr, tr, batches = _runners(tmp_path)
    scratch = type(tr)(tr.cfg, None, device="cpu")
    cal = jr._calibrate_fn()
    for batch in batches:
        upd, _, _ = cal(jr.variables, jnp.asarray(batch["img"]), jnp.asarray(batch["label"]))
        jr.merge_updates(upd)
        # the port's calibrate step on a scratch runner holding the
        # variables, its mutable collections merged back
        scratch.merge_updates(tr.variables)
        with torch.no_grad():
            scratch.model(torch.from_numpy(batch["img"]), mode="calibrate")
        tr.merge_updates({c: scratch.variables[c] for c in ("qobs", "qparams")})
    want, got = _flat(jax.device_get(jr.variables)), _flat(tr.variables)
    assert set(got) == set(want)
    for col in want:
        assert set(got[col]) == set(want[col]), col
    np.testing.assert_array_equal(got["params"]["conv1/kernel"], want["params"]["conv1/kernel"])
    for col in ("qparams", "qobs"):
        for key, val in want[col].items():
            np.testing.assert_allclose(got[col][key], val, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{col}/{key}")


@pytest.mark.parametrize("case", ["drop_leaf", "taps_ignored", "before_init"])
def test_merge_updates_replaces_collections_as_jax(tmp_path, case):
    from quantize_tpu_torch.runners import build_runner

    jr, tr, _ = _runners(tmp_path)
    full = jax.device_get(jr.variables)
    qp = convert.flatten(full["qparams"])
    dropped = "conv1/w_quantizer/zero"
    assert dropped in qp
    if case == "drop_leaf":
        updates = {"qparams": convert.unflatten({k: v for k, v in qp.items() if k != dropped})}
    elif case == "taps_ignored":
        updates = {"qparams": full["qparams"], "taps": {"conv1": {"out": np.zeros((2, 3))}}}
    else:
        tr = build_runner(tr.cfg, None, device="cpu")
        jr.variables = {}
        updates = {"params": full["params"], "qparams": full["qparams"]}
    jr.merge_updates(updates)
    tr.merge_updates(updates)
    want, got = _flat(jax.device_get(jr.variables)), _flat(tr.variables)
    assert "taps" not in got and "taps" not in want
    assert set(got) == set(want) and {c: set(v) for c, v in got.items()} == {
        c: set(v) for c, v in want.items()}
    if case == "drop_leaf":
        assert dropped not in got["qparams"] and "qobs" in got
    if case == "before_init":
        assert set(got) == {"params", "qparams"}
    for col in want:
        for key, val in want[col].items():
            np.testing.assert_array_equal(got[col][key], val, err_msg=f"{col}/{key}")


def test_merge_updates_takes_the_getters_flat_layout(tmp_path):
    """The getter's own ``{collection: {"path/leaf": tensor}}`` merged into
    a fresh runner gives the same quant-mode logits, bit for bit."""
    from quantize_tpu_torch.runners import build_runner

    _, tr, batches = _runners(tmp_path)
    img = torch.from_numpy(batches[1]["img"])
    with torch.no_grad():
        tr.model(img, mode="calibrate")
        want = tr.model(img, mode="quant")
    other = build_runner(tr.cfg, None, device="cpu")
    other.merge_updates(tr.variables)
    with torch.no_grad():
        got = other.model(img, mode="quant")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# quant_conv2d_wo(..., compute_dtype=)
# ---------------------------------------------------------------------------

WO_CASES = {
    "same_s1": dict(ci=16, co=24, strides=(1, 1), padding="SAME"),
    "same_s2": dict(ci=16, co=24, strides=(2, 2), padding="SAME"),
    "valid_s1": dict(ci=16, co=24, strides=(1, 1), padding="VALID"),
    "valid_s2": dict(ci=16, co=24, strides=(2, 2), padding="VALID"),
    "grouped": dict(ci=16, co=24, strides=(1, 1), padding="SAME", groups=4),
    "awq": dict(ci=6, co=5, strides=(2, 2), padding="SAME", awq=True),
    "awq_grouped": dict(ci=6, co=5, strides=(2, 2), padding="SAME", awq=True, group_size=9),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", WO_CASES)
def test_quant_conv2d_wo_compute_dtype_matches_jax(case, dtype):
    c = {"groups": 1, "awq": False, "group_size": 0, **WO_CASES[case]}
    rng = np.random.default_rng(17)
    ci, co, g = c["ci"], c["co"], c["groups"]
    x = rng.normal(size=(2, 9, 10, ci)).astype(np.float32)
    w = rng.integers(-128, 128, size=(3, 3, ci // g, co)).astype(np.int8)
    n_s = co * 9 * (ci // g) // c["group_size"] if c["group_size"] else co
    w_s = rng.uniform(0.001, 0.02, size=(n_s,)).astype(np.float32)
    w_z = rng.uniform(-2, 2, size=(n_s,)).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    recip = rng.uniform(0.5, 2.0, size=(ci,)).astype(np.float32) if c["awq"] else None
    args = (c["strides"], c["padding"], g)
    want = np.asarray(jqconv.quant_conv2d_wo(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(w_s), jnp.asarray(w_z), jnp.asarray(b),
        *args, getattr(jnp, dtype), None if recip is None else jnp.asarray(recip),
        c["group_size"]))
    got = tqconv.quant_conv2d_wo(_t(x), _t(w), _t(w_s), _t(w_z), _t(b), *args,
                                 getattr(torch, dtype), None if recip is None else _t(recip),
                                 c["group_size"])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == "bfloat16":  # the rounding is there: not the float32 result
        f32 = tqconv.quant_conv2d_wo(_t(x), _t(w), _t(w_s), _t(w_z), _t(b), *args,
                                     awq_recip=None if recip is None else _t(recip),
                                     group_size=c["group_size"])
        assert not torch.equal(got, f32)


# ---------------------------------------------------------------------------
# ``train``: BatchNorm on the batch's statistics
# ---------------------------------------------------------------------------

# W8A8 with BatchNorm left in the graph (no folding), so every model keeps
# its BatchNorms
W8A8_BN = {"default": {"weight": W8, "activation": A8}}
TRAIN_MODELS = {
    "testcnn": ("testcnn", {"num_classes": 10}, 16),
    "resnet18": ("resnet18", {"num_classes": 10}, 32),
    "wideresnet": ("wideresnet28", {"num_classes": 10, "widen_factor": 1}, 16),
}


@pytest.mark.parametrize("name", TRAIN_MODELS)
def test_train_batchnorm_matches_jax(name, mode="fp32"):
    """``model(x, mode, train=True)`` against JAX's ``apply(..., train=True,
    mutable=["batch_stats"])`` twice from the same variables: the logits
    within 1e-4 of max|logits| (float32 batch statistics summed in another
    order, through every BatchNorm of the net) and the running statistics
    moved the same way, rtol 1e-5 (atol 1e-6); ``train=False`` (the
    default) reads the running statistics unchanged. (MobileNets and CLIP's
    ResNet take their BatchNorms through ResNet's ``_Stage``, held here
    through ResNet-18, and the layer alone below.)"""
    from quantize_tpu.models import MODELS as JAX_MODELS
    from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx

    reg, kw, size = TRAIN_MODELS[name]
    rng = np.random.default_rng(23)
    x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    jm = JAX_MODELS.build(reg, ctx=JaxQuantCtx(W8A8_BN), **kw)
    v = dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mode="calibrate"))
    v.pop("taps", None)
    v = jax.device_get(v)
    assert "batch_stats" in v
    tm = qtt.MODELS.build(reg, ctx=qtt.QuantCtx(W8A8_BN), device="cpu", **kw)
    convert.from_jax_variables(tm, v)
    before = convert.flatten(convert.to_numpy(tm)["batch_stats"])
    for step in range(2):
        xs = x[::-1].copy() if step else x
        want, upd = jm.apply(v, jnp.asarray(xs), mode=mode, train=True, mutable=["batch_stats"])
        v = {**v, **jax.device_get(upd)}
        with torch.no_grad():
            got = tm(_t(xs), mode, True).numpy()
        want = np.asarray(want)
        # seen: 1.3e-6 (TestCNN, WRN), 3.4e-5 (ResNet-18, whose last
        # BatchNorms normalize over 4 rows of 1 x 1 pixels)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), step
        mine = convert.flatten(convert.to_numpy(tm)["batch_stats"])
        theirs = convert.flatten(v["batch_stats"])
        assert set(mine) == set(theirs) == set(before)
        for key, val in theirs.items():
            np.testing.assert_allclose(mine[key], np.asarray(val), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{step} {key}")
    moved = convert.flatten(convert.to_numpy(tm)["batch_stats"])
    assert any(not np.array_equal(moved[k], before[k]) for k in before)
    with torch.no_grad():
        tm(_t(x), mode)
    assert all(np.array_equal(convert.flatten(convert.to_numpy(tm)["batch_stats"])[k], moved[k])
               for k in moved)


@pytest.mark.parametrize("shape", [(6, 5, 7, 16), (32, 24)])
def test_train_batchnorm_layer_matches_flax(shape):
    """One BatchNorm on the batch's statistics against flax's ``nn.BatchNorm``
    (momentum 0.9, epsilon 1e-5) with ``use_running_average=False``: the
    output within rtol 1e-5 (atol 1e-6), the running mean and variance
    within rtol 1e-6 (atol 1e-6: float32 means summed in another order),
    both steps from the same start."""
    import flax.linen as fnn

    from quantize_tpu_torch.models.resnet import _BatchNorm

    rng = np.random.default_rng(29)
    c = shape[-1]
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = jax.device_get(dict(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    v["params"] = {"scale": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
                   "bias": rng.normal(size=(c,)).astype(np.float32)}
    v["batch_stats"] = {"mean": rng.normal(size=(c,)).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, size=(c,)).astype(np.float32)}
    bn = _BatchNorm(c, device="cpu")
    convert.from_jax_variables(bn, v)
    for step in range(2):
        want, upd = jbn.apply(v, jnp.asarray(x * (1 + step)), mutable=["batch_stats"])
        v = {**v, **jax.device_get(upd)}
        got = bn(_t(x * (1 + step)), train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        for leaf in ("mean", "var"):
            np.testing.assert_allclose(bn.get_var("batch_stats", leaf).numpy(),
                                       v["batch_stats"][leaf], rtol=1e-6, atol=1e-6,
                                       err_msg=leaf)
