"""Importing torchvision checkpoints into the port, held against the JAX
package on the CPU.

* ``fold_bn`` (both modes) is bit-equal to JAX's (the same numpy code).
* ``import_resnet`` on a torchvision-layout ResNet-18 state dict
  (``tests/golden/weightgen.py``, with ``num_batches_tracked`` buffers)
  gives the port's variables equal to JAX's, tree for tree: BN folded,
  into_scale (the weight quantizers' ``static_scale``) and unfolded (the
  ``_BN`` params and batch_stats).
* The importer is strict: a state-dict key or a model path that does not
  resolve raises KeyError (only ``static_scale`` may be created).
* ``init_model(torch_state_dict=...)`` then calibration gives JAX's
  calibrated qparams and observer state at rtol 1e-5 (float32
  reassociation of the calibrate pass's convolutions, ROADMAP.md §3): the
  observer reset drops the init pass's state.
* The CPU runner with ``model.torch_checkpoint`` matches JAX's runner on
  the same ``.pth``: per-step loss and top-1, calibrated state, val and
  test top-1 within one example; ``model.torch_checkpoint_sha256`` is
  checked before loading.
* ``import_mobilenet_v2``/``_v3`` and ``import_wideresnet`` (copies)
  give, from the same seeded torchvision-layout state dicts
  (``tests/test_import_mobilenet_wrn.py``'s generators) and the same
  variables tree, JAX's variables bit for bit, BN folded and unfolded; the
  port's trees have the JAX models' paths and shapes.
* No family waits: a model with no importer raises KeyError by name. The
  torchvision ViT and CLIP importers are held against JAX's in
  ``tests/test_torch_clip_import.py``.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantize_tpu.api as jax_api
import quantize_tpu.runners as jax_runners
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.models import import_auto as jax_import_auto
from quantize_tpu.models import import_torch as jax_import_torch
from quantize_tpu.models.import_resnet import import_resnet as jax_import_resnet
from quantize_tpu.models.manifest import sha256_of as jax_sha256_of
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
import quantize_tpu_torch as qtt
import quantize_tpu_torch.runners as runners
from quantize_tpu_torch import convert
from quantize_tpu_torch.models import import_auto, import_torch
from quantize_tpu_torch.models.import_resnet import import_resnet
from quantize_tpu_torch.models.manifest import sha256_of, verify_checkpoint
from quantize_tpu_torch.nn.quantizer import reset_observers
from quantize_tpu_torch.utils import Config

torch.set_num_threads(2)

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.join(_HERE, "golden"))
from test_e2e_ptq import base_cfg  # noqa: E402
from test_import_mobilenet_wrn import (synth_mobilenet_v2_sd,  # noqa: E402
                                       synth_mobilenet_v3_small_sd, synth_wrn_sd)
from weightgen import gen_param  # noqa: E402

with open(os.path.join(_HERE, "golden", "models.json")) as _f:
    _RN18 = {c["case"]: c for c in json.load(_f)["cases"]}["resnet18_w8a8_bnfold"]

_W = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
      "range": {"name": "minmax"}}
_A = {"n_bits": 8, "symmetric": False, "granularity": "layer",
      "range": {"name": "maminmax", "momentum": 0.1}}
# (ctx bn_folding, importer fold_bn, into_scale)
MODES = {"bnfold": (True, True, False), "intoscale": ({"into_scale": True}, True, True),
         "unfolded": (False, False, False)}


def _quant(bn_folding):
    return {"default": {"weight": _W, "activation": _A, "bn_folding": bn_folding}}


def _state_dict(num_classes=10):
    """ResNet-18 in torchvision's layout, with num_batches_tracked buffers."""
    sd = {}
    for name, shape in _RN18["param_names"]:
        if name.startswith("fc."):
            shape = (num_classes, *shape[1:])
        sd[name] = gen_param(name, tuple(shape))
        if name.endswith(".running_var"):
            sd[name.replace("running_var", "num_batches_tracked")] = np.asarray(7, np.int64)
    return sd


def _jax_tree(bn_folding):
    """The JAX ResNet-18's variables as shapes (the importer reads only the
    tree and its shapes)."""
    model = JAX_MODELS.build("resnet18", num_classes=10, ctx=JaxQuantCtx(_quant(bn_folding)))
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, mode="calibrate"))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  {k: v for k, v in dict(tree).items() if k != "taps"})


def _port_model(bn_folding):
    return qtt.MODELS.build("resnet18", num_classes=10, ctx=qtt.QuantCtx(_quant(bn_folding)),
                            device="cpu")


@pytest.mark.parametrize("into_scale", [False, True])
@pytest.mark.parametrize("conv_bias", [False, True])
def test_fold_bn_is_bit_equal_to_jax(into_scale, conv_bias):
    rng = np.random.default_rng(int(into_scale) * 2 + int(conv_bias))
    w = rng.normal(size=(8, 4, 3, 3)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32) if conv_bias else None
    bn = [rng.uniform(0.5, 1.5, 8), rng.normal(size=8), rng.normal(size=8) * 0.1,
          rng.uniform(0.5, 1.5, 8)]
    bn = [a.astype(np.float32) for a in bn]
    mine = import_torch.fold_bn(torch.from_numpy(w), None if b is None else torch.from_numpy(b),
                                *map(torch.from_numpy, bn), into_scale=into_scale)
    theirs = jax_import_torch.fold_bn(w, b, *bn, into_scale=into_scale)
    for m, t in zip(mine, theirs):
        if t is None:
            assert m is None
        else:
            assert m.dtype == t.dtype == np.float32
            np.testing.assert_array_equal(m, t)
    assert (mine[2] is not None) == into_scale


@pytest.mark.parametrize("mode", sorted(MODES))
def test_import_resnet_gives_jax_variables(mode):
    bn_folding, fold, into_scale = MODES[mode]
    sd = _state_dict()
    theirs = jax_import_resnet(sd, _jax_tree(bn_folding), fold_bn=fold, into_scale=into_scale)
    model = _port_model(bn_folding)
    import_auto.import_into_model(model, "resnet18", {k: torch.from_numpy(np.asarray(v))
                                                      for k, v in sd.items()},
                                  fold_bn=fold, into_scale=into_scale)
    mine = convert.to_numpy(model)
    cols = ("params", "batch_stats") if mode == "unfolded" else ("params",)
    assert ("batch_stats" in mine) == (mode == "unfolded")
    for col in cols:
        m, t = convert.flatten(mine[col]), convert.flatten(theirs[col])
        assert set(m) == set(t), col
        for key, val in t.items():
            assert m[key].dtype == np.float32
            np.testing.assert_array_equal(m[key], val, err_msg=f"{col}/{key}")
    ss = {k: v for k, v in convert.flatten(mine["qparams"]).items() if k.endswith("static_scale")}
    ss_t = {k: v for k, v in convert.flatten(theirs["qparams"]).items()
            if k.endswith("static_scale")}
    assert set(ss) == set(ss_t) and (len(ss) == 20) == into_scale  # every conv, not fc
    for key, val in ss_t.items():
        np.testing.assert_array_equal(ss[key], val, err_msg=key)


def test_import_is_strict():
    sd = _state_dict()
    # a misnamed state-dict key
    bad = dict(sd)
    bad["layer2.0.bn1.gamma"] = bad.pop("layer2.0.bn1.weight")
    with pytest.raises(KeyError, match="layer2.0.bn1.weight"):
        import_auto.import_into_model(_port_model(True), "resnet18", bad)
    # a model path that does not exist: folding writes conv biases the
    # unfolded model does not have
    with pytest.raises(KeyError, match="bias"):
        import_auto.import_into_model(_port_model(False), "resnet18", sd, fold_bn=True)
    tree = {"conv1": {"kernel": np.zeros((7, 7, 3, 64), np.float32)}}
    with pytest.raises(KeyError, match="conv9"):
        import_torch.set_leaf(tree, "conv9/kernel", np.zeros(1))
    with pytest.raises(KeyError, match="bias"):
        import_torch.set_leaf(tree, "conv1/bias", np.zeros(64))
    with pytest.raises(ValueError, match="shape mismatch"):
        import_torch.set_leaf(tree, "conv1/kernel", np.zeros((3, 3, 3, 64)))
    import_torch.set_leaf(tree, "conv1/w_quantizer/static_scale", np.ones(64), allow_new=True)
    assert tree["conv1"]["w_quantizer"]["static_scale"].shape == (64,)


def test_load_torch_state_dict_matches_jax(tmp_path):
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in _state_dict().items()}
    wrapped = tmp_path / "wrapped.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, wrapped)
    mine = import_auto.load_torch_state_dict(str(wrapped))
    theirs = jax_import_auto.load_torch_state_dict(str(wrapped))
    assert set(mine) == set(theirs) == set(sd)
    for k, v in theirs.items():
        assert torch.equal(mine[k], v)


@pytest.fixture(scope="module", params=sorted(MODES))
def calibrated(request):
    """JAX's and the port's ResNet-18 from the same state dict through
    init_model(torch_state_dict=...) and two calibration batches."""
    bn_folding, fold, into_scale = MODES[request.param]
    sd = _state_dict()
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=(2, 32, 32, 3)).astype(np.float32) for _ in range(3)]
    jm = JAX_MODELS.build("resnet18", num_classes=10, ctx=JaxQuantCtx(_quant(bn_folding)))
    v = jax_api.init_model(jm, jnp.asarray(xs[0]), torch_state_dict=sd, model_name="resnet18",
                           fold_bn=fold, into_scale=into_scale)
    v = jax.device_get(jax_api.calibrate_model(jm, v, [jnp.asarray(x) for x in xs[1:]]))
    tm = _port_model(bn_folding)
    qtt.init_model(tm, xs[0], seed=3, torch_state_dict={k: torch.from_numpy(np.asarray(a))
                                                        for k, a in sd.items()},
                   model_name="resnet18", fold_bn=fold, into_scale=into_scale, device="cpu")
    qtt.calibrate_model(tm, xs[1:], device="cpu")
    with torch.no_grad():
        fp = (tm(torch.from_numpy(xs[0]), mode="fp32").numpy(),
              np.asarray(jm.apply(v, jnp.asarray(xs[0]), mode="fp32")))
    return convert.to_numpy(tm), v, fp


def test_init_model_with_a_torch_checkpoint_calibrates_as_jax(calibrated):
    mine, theirs, (fp_mine, fp_theirs) = calibrated
    for col in ("qparams", "qobs"):
        m, t = convert.flatten(mine[col]), convert.flatten(theirs[col])
        assert set(m) == set(t), col
        for key, val in t.items():
            if key.endswith("count"):
                np.testing.assert_array_equal(m[key], val, err_msg=key)
            else:
                np.testing.assert_allclose(m[key], val, rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(fp_mine, fp_theirs, rtol=1e-5, atol=1e-5 * np.abs(fp_theirs).max())


def test_reset_observers_drops_qobs_and_keeps_qparams():
    quant = _quant({"into_scale": True})
    quant["default"]["bias_correct"] = {"momentum": 0.1}
    model = qtt.MODELS.build("resnet18", num_classes=10, ctx=qtt.QuantCtx(quant), device="cpu")
    qtt.init_model(model, np.zeros((1, 32, 32, 3), np.float32), torch_state_dict=_state_dict(),
                   model_name="resnet18", into_scale=True, device="cpu")
    cols = convert.to_numpy(model)
    assert "qobs" not in cols
    assert sum(k.endswith("static_scale") for k in convert.flatten(cols["qparams"])) == 20
    qtt.calibrate_model(model, [np.ones((1, 32, 32, 3), np.float32)], device="cpu")
    obs = convert.flatten(convert.to_numpy(model)["qobs"])
    assert any(k.endswith("bias_correct_EX/EX") for k in obs)
    reset_observers(model)
    assert "qobs" not in convert.to_numpy(model)


def test_a_model_without_an_importer_raises_by_name():
    with pytest.raises(KeyError, match="no torch-checkpoint importer"):
        import_auto.import_torch_checkpoint("alexnet", {}, {"params": {}})


# (importer name, registry name, state dict, constructor keywords): WRN-28
# at widen 2 (the importer reads the depth from the name, not the width)
_FAMILIES = {
    "mobilenet_v2": ("mobilenet_v2", lambda: synth_mobilenet_v2_sd(np.random.default_rng(2)), {}),
    "mobilenet_v3_small": ("mobilenet_v3_small",
                           lambda: synth_mobilenet_v3_small_sd(np.random.default_rng(3)), {}),
    "wideresnet28": ("wideresnet28", lambda: synth_wrn_sd(np.random.default_rng(4), depth=28),
                     {"widen_factor": 2}),
    "rb_wrn28_10": ("rb_wrn-28-10", lambda: synth_wrn_sd(np.random.default_rng(5), depth=28),
                    {"widen_factor": 2}),
}


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("name", sorted(_FAMILIES))
def test_mobilenet_and_wrn_importers_give_jax_variables(name, fold):
    """The importer copies against JAX's on one state dict and one tree:
    the JAX model's (abstract) variables, whose paths and shapes must be
    the port model's, filled by JAX's importer and by the port's through
    ``import_into_model``, bit for bit."""
    registry, make_sd, kw = _FAMILIES[name]
    quant = {"default": {"weight": {"n_bits": 32}, "activation": {"n_bits": 32},
                         "bn_folding": fold}}
    jm = JAX_MODELS.build(registry, num_classes=10, ctx=JaxQuantCtx(quant), **kw)
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, mode="calibrate"))
    tree = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  {k: v for k, v in dict(tree).items() if k != "taps"})
    model = qtt.MODELS.build(registry, num_classes=10, ctx=qtt.QuantCtx(quant), device="cpu",
                             **kw)
    before = convert.to_numpy(model)
    for col in ("params", "batch_stats"):
        m, t = convert.flatten(before.get(col, {})), convert.flatten(tree.get(col, {}))
        assert {k: v.shape for k, v in m.items()} == {k: v.shape for k, v in t.items()}, col
    sd = make_sd()
    theirs = jax_import_auto.import_torch_checkpoint(name, sd, tree, fold_bn=fold)
    import_auto.import_into_model(model, name, {k: torch.from_numpy(np.asarray(v))
                                                for k, v in sd.items()}, fold_bn=fold)
    mine = convert.to_numpy(model)
    assert ("batch_stats" in theirs) == ("batch_stats" in mine)
    for col in ("params", "batch_stats"):
        m, t = convert.flatten(mine.get(col, {})), convert.flatten(theirs.get(col, {}))
        assert set(m) == set(t), col
        for key, val in t.items():
            np.testing.assert_array_equal(m[key], val, err_msg=f"{col}/{key}")


def test_resnet_family_names_go_to_the_resnet_importer():
    for name in ("resnet18", "resnet50", "resnext50_32x4d", "wide_resnet50_2"):
        assert import_auto._importer_for(name) is import_resnet
        assert jax_import_auto._importer_for(name) is jax_import_resnet


def test_sha256_check_matches_jax(tmp_path):
    p = tmp_path / "ckpt.pth"
    p.write_bytes(b"not really a checkpoint")
    assert sha256_of(str(p)) == jax_sha256_of(str(p))
    verify_checkpoint(str(p), sha256_of(str(p)))
    verify_checkpoint(str(p), "auto", model_name="resnet18")
    for expected, name in (("0" * 64, ""), ("auto", "clip_vit-b16")):
        with pytest.raises(ValueError, match="sha256 mismatch"):
            verify_checkpoint(str(p), expected, model_name=name)


# -- the runner ------------------------------------------------------------------------

def _runner_cfg(out_dir, ckpt, **model):
    cfg = base_cfg(out_dir)
    cfg.merge_from_dict({
        "model": {"name": "resnet18", "num_classes": 10, "torch_checkpoint": str(ckpt), **model},
        "train_dataset": {"n": 32, "image_size": 32}, "val_dataset": {"n": 16, "image_size": 32},
        "test_dataset": {"n": 16, "image_size": 32}, "train_loader": {"batch_size": 16},
        "val_loader": {"batch_size": 16}, "test_loader": {"batch_size": 16}})
    return cfg


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "resnet18.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in _state_dict().items()}, path)
    return path


def _record(runner, rec):
    step, evaluate = runner.train_step, runner.evaluate

    def train_step(*args):
        out = step(*args)
        rec["steps"].append(out[:2])
        return out

    def evaluate_rec(loader, quantized=False):
        rec["evals"].append(evaluate(loader, quantized=quantized))
        return rec["evals"][-1]

    runner.train_step, runner.evaluate = train_step, evaluate_rec
    rec["runner"] = runner
    return runner


def test_runner_imports_the_checkpoint_as_jax(ckpt, tmp_path):
    jax_rec, port_rec = {"steps": [], "evals": []}, {"steps": [], "evals": []}
    jax_build, port_build = jax_runners.build_runner, runners.build_runner
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_runners, "build_runner", lambda *a, **k: _record(jax_build(*a, **k), jax_rec))
        mp.setattr(runners, "build_runner", lambda *a, **k: _record(port_build(*a, **k), port_rec))
        jax_runners.execute_runner(_runner_cfg(tmp_path / "jax", ckpt))
        sha = sha256_of(str(ckpt))
        runners.execute_runner(Config(_runner_cfg(tmp_path / "port", ckpt,
                                                  torch_checkpoint_sha256=sha).to_dict()),
                               device="cpu")
    assert len(port_rec["steps"]) == len(jax_rec["steps"]) == 2
    np.testing.assert_allclose(np.asarray(port_rec["steps"]), np.asarray(jax_rec["steps"]),
                               rtol=1e-5)
    mine = convert.to_numpy(port_rec["runner"].model)
    theirs = jax.device_get(jax_rec["runner"].variables)
    for col in ("params", "qparams", "qobs"):
        m, t = convert.flatten(mine[col]), convert.flatten(theirs[col])
        assert set(m) == set(t), col
        for key, val in t.items():
            if key.endswith("count"):
                np.testing.assert_array_equal(m[key], val, err_msg=key)
            else:
                np.testing.assert_allclose(m[key], val, rtol=1e-5, atol=1e-7, err_msg=key)
    assert len(port_rec["evals"]) == len(jax_rec["evals"]) == 2
    for m, t in zip(port_rec["evals"], jax_rec["evals"]):
        assert m["n"] == t["n"] == 16
        assert abs(m["top1"] - t["top1"]) * m["n"] / 100.0 <= 1.0 + 1e-9


def test_runner_refuses_a_checkpoint_with_the_wrong_sha256(ckpt, tmp_path):
    cfg = Config(_runner_cfg(tmp_path, ckpt, torch_checkpoint_sha256="f" * 64).to_dict())
    runner = runners.build_runner(cfg, device="cpu")
    batch = {"img": np.zeros((2, 32, 32, 3), np.float32), "label": np.zeros(2, np.int32)}
    with pytest.raises(ValueError, match="sha256 mismatch"):
        runner.init_variables(batch)
