"""The port's PTQ pipeline (quantize_tpu_torch.models.testnet, .runners,
.cli) held against the JAX package on the CPU.

* TestCNN and TrajNet, BN folding on and off, from JAX's variables (the
  BatchNorms given random statistics): fp32 logits rtol 1e-5 (of
  max|logits|); calibrated qparams and observer state rtol 1e-5 (float32
  reassociation, ROADMAP.md §3); quant-mode logits within the network's own
  quantization-noise envelope, as
  tests/test_torch_resnet.py::test_quant_logits_within_the_quantization_noise;
  packed integer buffers bit-equal and packed logits within 1e-3 of
  max|logits|, the criterion of
  tests/test_torch_resnet.py::test_packed_logits_match_jax.
* The runner: execute_runner in both packages on the config of
  tests/test_e2e_ptq.py::base_cfg (TestCNN, 16 x 16, 256 / 128 / 128
  images, batch 64) and on the CPU config as users run it (32 x 32, 160
  calibration images at batch 64: the third batch is padded with 32 zero
  images, which both runners calibrate on), the port starting from JAX's
  variables after init:
  per-step loss and top-1 rtol 1e-5, calibrated qparams and observer state
  rtol 1e-5, val and test quant-mode top-1 within one example; a
  checkpoint loads back bit-equal.
* The CLI: ``setup_cfg`` gives JAX's config, and ``main`` runs the CPU
  config to a test result with ``--device cpu``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_e2e_ptq import base_cfg

import quantize_tpu.runners as jax_runners
from quantize_tpu.cli import setup_cfg as jax_setup_cfg
from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.utils import Config as JaxConfig
import quantize_tpu_torch as qtt
import quantize_tpu_torch.runners as runners
from quantize_tpu_torch import cli, convert
from quantize_tpu_torch.utils import Config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CFG_FILE = "configs/runners/ptq/minmax/ptq_rn18_w8a8_synthetic.yaml"


def _quant(bn_folding):
    return {"default": {
        "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
                   "range": {"name": "minmax"}},
        "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                       "range": {"name": "maminmax", "momentum": 0.1}},
        "bn_folding": bn_folding}}


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / np.max(np.abs(b)))


def _assert_states_match(mine, theirs):
    """qparams and qobs: counts equal, the rest rtol 1e-5."""
    for col in ("qparams", "qobs"):
        m, t = convert.flatten(mine[col]), convert.flatten(theirs[col])
        assert set(m) == set(t), col
        for key, val in t.items():
            if key.endswith("count"):
                np.testing.assert_array_equal(m[key], val, err_msg=key)
            else:
                np.testing.assert_allclose(m[key], val, rtol=1e-5, atol=1e-7, err_msg=key)


@pytest.fixture(scope="module", params=[("testcnn", True), ("testcnn", False),
                                        ("trajnet", True), ("trajnet", False)],
                ids=lambda p: f"{p[0]}-{'bnfold' if p[1] else 'bn'}")
def model_case(request):
    name, fold = request.param
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    x_cal = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    cfg = _quant(fold)
    jm = JAX_MODELS.build(name, num_classes=10, ctx=JaxQuantCtx(cfg))
    v0 = jax.device_get(dict(jm.init(jax.random.PRNGKey(0), xj, mode="calibrate")))
    v0.pop("taps", None)
    if "batch_stats" in v0:  # non-identity BatchNorms
        v0["batch_stats"] = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32), v0["batch_stats"])
        v0["params"] = {**v0["params"], **jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32),
            {k: v for k, v in v0["params"].items() if k.startswith("bn")})}
    _, upd = jm.apply(v0, jnp.asarray(x_cal), mode="calibrate", mutable=["qobs", "qparams"])
    v1 = jax.device_get({**v0, **upd})

    tm = qtt.MODELS.build(name, num_classes=10, ctx=qtt.QuantCtx(cfg), device="cpu")
    convert.from_jax_variables(tm, v0)
    qtt.calibrate_model(tm, [x_cal], device="cpu")
    out = {"calibrated": (convert.to_numpy(tm), v1), "has_bn": "batch_stats" in v0}

    convert.from_jax_variables(tm, v1)
    with torch.no_grad():
        for mode in ("fp32", "quant"):
            out[mode] = (tm(torch.from_numpy(x), mode=mode).numpy(),
                         np.asarray(jm.apply(v1, xj, mode=mode)))
    deploy = jax_pack_model(jm, v1, xj)
    qtt.pack_model(tm, x, device="cpu")
    out["packed_buffers"] = (convert.flatten(convert.to_numpy(tm)["packed"]),
                             convert.flatten(jax.device_get(deploy["packed"])))
    with torch.no_grad():
        out["packed"] = (tm(torch.from_numpy(x), mode="packed").numpy(),
                         np.asarray(jm.apply(deploy, xj, mode="packed")))
    return out


def test_model_fp32_logits_match_jax(model_case):
    got, want = model_case["fp32"]
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_model_calibrated_qparams_and_observers_match(model_case):
    _assert_states_match(*model_case["calibrated"])
    assert ("batch_stats" in model_case["calibrated"][0]) == model_case["has_bn"]


def test_model_quant_logits_within_the_quantization_noise(model_case):
    got, want = model_case["quant"]
    noise = np.abs(want - model_case["fp32"][1])
    assert np.max(np.abs(got - want)) <= noise.max()
    assert np.mean(np.abs(got - want)) <= noise.mean()


def test_model_packed_matches_jax(model_case):
    mine, theirs = model_case["packed_buffers"]
    assert set(mine) == set(theirs)
    for key, val in theirs.items():
        assert mine[key].dtype == np.asarray(val).dtype, key
        if key.endswith(("w_int", "col_sum", "corr_a")):
            np.testing.assert_array_equal(mine[key], val, err_msg=key)
        else:
            np.testing.assert_allclose(mine[key], val, rtol=1e-6, atol=0, err_msg=key)
    got, want = model_case["packed"]
    assert got.shape == want.shape == (4, 10)
    assert _rel(got, want) <= 1e-3


# -- the runner ------------------------------------------------------------------------


@pytest.mark.parametrize("n", [32, 64])
def test_pad_batch_matches_jax(n):
    """The trailing batch is padded with zero images and label -1, as the
    JAX runner pads it (its calibration steps see the zeros)."""
    from quantize_tpu.runners.base import pad_batch as jax_pad_batch
    from quantize_tpu_torch.runners.base import pad_batch

    rng = np.random.default_rng(n)
    batch = {"img": rng.normal(size=(n, 4, 4, 3)).astype(np.float32),
             "label": rng.integers(0, 10, size=n).astype(np.int32)}
    mine, theirs = pad_batch(batch, 64), jax_pad_batch(batch, 64)
    for key in ("img", "label"):
        assert mine[key].dtype == theirs[key].dtype and mine[key].shape[0] == 64
        np.testing.assert_array_equal(mine[key], theirs[key])


def test_masked_topk_correct_matches_jax_on_ties():
    """Top-1 from a stable argsort, as ``jnp.argsort``: tied logits pick the
    lowest class; label -1 (padding) is neither correct nor counted."""
    from quantize_tpu.runners.base import masked_topk_correct as jax_topk
    from quantize_tpu_torch.runners.base import masked_topk_correct

    rng = np.random.default_rng(3)
    logits = rng.integers(0, 3, size=(256, 10)).astype(np.float32)  # many ties
    labels = rng.integers(-1, 10, size=256).astype(np.int32)
    for k in (1, 3):
        c, t = masked_topk_correct(torch.from_numpy(logits), torch.from_numpy(labels), k)
        cj, tj = jax_topk(jnp.asarray(logits), jnp.asarray(labels), k)
        assert (int(c), int(t)) == (int(cj), int(tj))



def _instrumented(runner, record):
    """Record the runner's steps and evaluations."""
    step, evaluate = runner.train_step, runner.evaluate

    def train_step(*args):
        out = step(*args)
        record["steps"].append(out[:2])
        return out

    def evaluate_rec(loader, quantized=False):
        result = evaluate(loader, quantized=quantized)
        record["evals"].append(result)
        return result

    runner.train_step, runner.evaluate = train_step, evaluate_rec
    record["runner"] = runner
    return runner


def _yaml_cfg(cls, out_dir):
    cfg = cls()
    cfg.merge_from_yaml(str(ROOT / CFG_FILE))
    cfg.merge_from_dict({"output_dir": str(out_dir)})
    return cfg


# (config, calibration steps, val images)
RUNS = {"e2e": (lambda d: base_cfg(d), 4, 128),
        "synthetic_yaml": (lambda d: _yaml_cfg(JaxConfig, d), 3, 256)}


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, tmp_path_factory):
    make_cfg, n_steps, n_val = RUNS[request.param]
    jax_rec = {"steps": [], "evals": [], "n_steps": n_steps, "n_val": n_val}
    port_rec = {"steps": [], "evals": []}
    jax_build, port_build = jax_runners.build_runner, runners.build_runner

    def jax_build_rec(*args, **kw):
        runner = _instrumented(jax_build(*args, **kw), jax_rec)
        init = runner.init_variables

        def init_and_keep(batch, seed=0):
            init(batch, seed)
            jax_rec["v0"] = jax.device_get(runner.variables)

        runner.init_variables = init_and_keep
        return runner

    def port_build_rec(*args, **kw):
        runner = _instrumented(port_build(*args, **kw), port_rec)
        runner.variables = jax_rec["v0"]  # JAX's variables after its init
        return runner

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_runners, "build_runner", jax_build_rec)
        mp.setattr(runners, "build_runner", port_build_rec)
        jcfg = make_cfg(tmp_path_factory.mktemp("jax"))
        jax_rec["result"] = jax_runners.execute_runner(jcfg)
        pcfg = Config(make_cfg(tmp_path_factory.mktemp("port")).to_dict())
        port_rec["result"] = runners.execute_runner(pcfg, device="cpu")
    jax_rec["final"] = jax.device_get(jax_rec["runner"].variables)
    port_rec["final"] = convert.to_numpy(port_rec["runner"].model)
    port_rec["cfg"] = pcfg
    return jax_rec, port_rec


def test_runner_steps_match_jax(runs):
    jax_rec, port_rec = runs
    assert len(port_rec["steps"]) == len(jax_rec["steps"]) == jax_rec["n_steps"]
    np.testing.assert_allclose(np.asarray(port_rec["steps"]), np.asarray(jax_rec["steps"]),
                               rtol=1e-5)


def test_runner_calibrated_state_matches_jax(runs):
    jax_rec, port_rec = runs
    _assert_states_match(port_rec["final"], jax_rec["final"])


def test_runner_val_and_test_top1_within_one_example(runs):
    jax_rec, port_rec = runs
    # the val split once at the end of the epoch, then the test split
    assert len(port_rec["evals"]) == len(jax_rec["evals"]) == 2
    assert port_rec["evals"][-1] == port_rec["result"]
    for mine, theirs in zip(port_rec["evals"], jax_rec["evals"]):
        assert mine["n"] == theirs["n"] == jax_rec["n_val"]
        assert abs(mine["top1"] - theirs["top1"]) * mine["n"] / 100.0 <= 1.0 + 1e-9


def test_runner_checkpoint_loads_bit_equal(runs):
    _, port_rec = runs
    cfg, runner = port_rec["cfg"], port_rec["runner"]
    out = Path(cfg.output_dir)
    assert (out / "ckpt_last.pkl").exists() and cfg.runner.best == str(out / "ckpt_best.pkl")
    fresh = runners.build_runner(cfg, device="cpu")
    assert fresh.variables == {}
    extra = fresh.load_checkpoint(cfg.runner.best)
    assert extra["eval"] == port_rec["evals"][0]
    mine, theirs = convert.to_numpy(fresh.model), convert.to_numpy(runner.model)
    assert set(mine) == set(theirs)
    for col in theirs:
        flat_m, flat_t = convert.flatten(mine[col]), convert.flatten(theirs[col])
        assert set(flat_m) == set(flat_t), col
        for key, val in flat_t.items():
            assert flat_m[key].dtype == val.dtype
            np.testing.assert_array_equal(flat_m[key], val, err_msg=f"{col}/{key}")
    batch = next(runner._prefetch(runner.test_loader))
    assert torch.equal(fresh.eval_step(batch, quantized=True),
                       runner.eval_step(batch, quantized=True))


@pytest.mark.parametrize("name", ["qat", "adaround"])
def test_runners_not_ported_raise(tmp_path, name):
    """Neither training runner raises not-ported: ``build_runner`` makes a
    working QAT and AdaRound runner, and ``execute_runner`` runs each on
    TestCNN on the CPU to a finite top-1; its best checkpoint (AdaRound's
    holding ``adaround``) reloads bit-equal."""
    quant = None
    if name == "adaround":
        quant = {"default": {"weight": {"n_bits": 4, "symmetric": True, "signed": True,
                                        "granularity": "channel", "range": {"name": "minmax"},
                                        "adaround": {"apply": True}}}}
    cfg = Config(base_cfg(tmp_path, runner=name, quant_extra=quant,
                          train_extra={"calibrated_epoch": 1, "eval_freq": 1}).to_dict())
    assert isinstance(runners.build_runner(cfg, device="cpu"),
                      runners.QAT if name == "qat" else runners.AdaRound)
    result = runners.execute_runner(cfg, device="cpu")
    assert np.isfinite(result["top1"]) and 0.0 <= result["top1"] <= 100.0 and result["n"] == 128
    fresh = runners.build_runner(cfg, device="cpu")
    fresh.load_checkpoint(cfg.runner.best)
    want = torch.load(cfg.runner.best, weights_only=True)["variables"]
    assert ("adaround" in want) == (name == "adaround")
    got = convert.to_numpy(fresh.model)
    for col, tree in want.items():
        flat = convert.flatten(got[col])
        for key, t in convert.flatten(tree).items():
            np.testing.assert_array_equal(flat[key], t.numpy(), err_msg=f"{col}/{key}")


def test_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    """The default device is CUDA, with no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(base_cfg(tmp_path).to_dict())
    for call in (lambda: runners.build_runner(cfg), lambda: runners.execute_runner(cfg),
                 lambda: cli.main(["--cfg", CFG_FILE, "--output-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- the CLI ---------------------------------------------------------------------------


def test_setup_cfg_matches_jax(tmp_path):
    import argparse

    args = argparse.Namespace(cfg=[CFG_FILE], output_dir=str(tmp_path),
                              opts=["seed=3", "train.max_epoch=2", "model.width=8"])
    assert cli.setup_cfg(args).to_dict() == jax_setup_cfg(args).to_dict()


def test_cli_runs_the_cpu_config_to_a_test_result(tmp_path):
    cli.main(["--cfg", CFG_FILE, "--device", "cpu", "--output-dir", str(tmp_path)])
    log = (tmp_path / "output.log").read_text()
    assert "test result: {'top1': " in log and "'n': 256}" in log
    for name in ("cfg.yaml", "ckpt_last.pkl", "ckpt_best.pkl"):
        assert (tmp_path / name).exists(), name
    saved = Config()
    saved.merge_from_yaml(str(tmp_path / "cfg.yaml"))
    assert saved.model.name == "testcnn" and saved.output_dir == str(tmp_path)
