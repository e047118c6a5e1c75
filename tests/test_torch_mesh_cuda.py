"""Phases 12b/12c and 14 of ``chip_smoke.py`` at a tiny width, on the card,
two ranks sharing it over gloo (``tests/_torch_mesh.py``'s worker with
``device="cuda"``).

* One sharded QAT step of ResNet-18 W8A8 (32 px, 16 classes, the QAT
  configs' activations) at ``(2, 1)`` and ``(1, 2)``: the loss finite and
  within 1e-2 relative of the one-device step on the card (a split batch
  or a split layer changes cuDNN's sums, which can move an int8 activation
  step: the bound is the quantization noise, not f32's), the ranks'
  variables bit-equal after the step, and the step's collectives exactly
  those of the CPU tests.
* The QAT runner (two calibration steps, then two SGD steps) and the
  blockwise AdaRound runner (W4 weight-only, two cached batches) on
  TestCNN (16 px, 10 classes, two global batches of 8) at ``(2, 1)``: the
  ranks' variables bit-equal; every QAT step's collectives those of
  ``tests/test_torch_mesh_qat_runner.py``, its calibration losses within
  1e-5 relative of the one-device run on the card (its training losses
  finite: from there quant-mode noise grows); AdaRound's layer order and
  losses the same on both ranks, its order one device's, its rounding
  decisions one device's wherever that device's |V| > 2e-2 (``tests/
  test_torch_adaround_runner.py``'s criterion).

This file imports no JAX, so it runs on the card's machine with
``--noconftest``; here the ``cuda`` marker's tests skip.
"""
import numpy as np
import pytest
import torch

from _torch_mesh import ArrayLoader, run_jobs

CFG = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "maminmax", "momentum": 0.1}},
    "bn_folding": True}}
LABEL = np.array([3, -1, 15, 7], np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_sharded_qat_step_on_the_card(tmp_path, mesh):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the GPU machine)")
    import quantize_tpu_torch as qtt
    from quantize_tpu_torch.nn.variables import collections
    from quantize_tpu_torch.runners.qat import loss_and_grads

    dp, tp = mesh
    x = np.random.default_rng(5).normal(size=(2 * dp, 32, 32, 3)).astype(np.float32)
    model = qtt.MODELS.build("resnet18", num_classes=16, ctx=qtt.QuantCtx(CFG),
                             device="cuda")
    qtt.init_model(model, x, seed=0, device="cuda")
    torch.save({c: {k: t.detach().cpu() for k, t in f.items()}
                for c, f in collections(model).items()}, tmp_path / "v.pt")
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "label.npy", LABEL[:2 * dp])
    loss, _, _ = loss_and_grads(model, torch.from_numpy(x).cuda(),
                                torch.from_numpy(LABEL[:2 * dp]).cuda())
    job = {"name": "step", "mesh": [dp, tp], "device": "cuda",
           "build": {"name": "resnet18", "kw": {"num_classes": 16}}, "cfg": CFG,
           "variables": str(tmp_path / "v.pt"), "x": str(tmp_path / "x.npy"),
           "label": str(tmp_path / "label.npy"), "step": 1e-3, "out": str(tmp_path / "step")}
    reports, saved = run_jobs(2, [job], tmp_path)
    want = ({"all-reduce": 2} if dp > 1 else {"all-gather": 21, "all-reduce": 21})
    for rank in range(2):
        got = saved[rank]["step"]
        assert reports[rank]["step"]["step"] == want
        assert np.isfinite(float(got["loss"]))
        assert abs(float(got["loss"]) - float(loss)) <= 1e-2 * abs(float(loss))
        for key, t in got["updated"].items():
            assert torch.equal(t, saved[0]["step"]["updated"][key]), (rank, key)


W8 = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
      "range": {"name": "minmax"}}
RUNNER_QUANT = {
    "qat": {"default": {"weight": W8, "activation": CFG["default"]["activation"],
                        "bn_folding": True}},
    "adaround": {"default": {"weight": {**W8, "n_bits": 4, "adaround": {"apply": True}},
                             "activation": {"n_bits": 32}, "bn_folding": True}}}


def _runner_cfg(out, kind):
    runner = {"name": kind}
    train = {"max_epoch": 1, "print_freq": 1000, "eval_freq": 0}
    optimizer = {"name": "sgd", "lr": 1e-3}
    if kind == "qat":
        train["calibrated_epoch"] = 1
    else:
        runner.update(reconstruction="blockwise", beta="dynamic")
        optimizer = {"name": "adam", "lr": 1e-3}
    return {"seed": 0, "output_dir": str(out), "model": {"name": "testcnn", "num_classes": 10},
            "runner": runner, "quant": RUNNER_QUANT[kind], "train": train,
            "optimizer": optimizer, "lr_scheduler": {"name": "constant"}}


def _decisions(flat):
    out = {}
    for key in (k for k in flat if k.startswith("adaround/")):
        path = key[len("adaround/"):-len("/w_quantizer/V")]
        v = flat[key].float().cpu()
        w_over = (flat[f"params/{path}/kernel"].cpu()
                  / flat[f"qparams/{path}/w_quantizer/scale"].cpu()
                  - flat[f"qparams/{path}/w_quantizer/zero"].cpu())
        out[path] = (v.reshape(-1), (torch.floor(w_over) + (v >= 0)).reshape(-1))
    return out


@pytest.mark.cuda
def test_runners_on_a_data_parallel_mesh_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the GPU machine)")
    from quantize_tpu_torch.nn.variables import collections
    from quantize_tpu_torch.runners import build_runner
    from quantize_tpu_torch.utils import Config

    rng = np.random.default_rng(14)
    batches = [{"img": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 8).astype(np.int32)} for _ in range(2)]
    np.savez(tmp_path / "batches.npz", img=np.stack([b["img"] for b in batches]),
             label=np.stack([b["label"] for b in batches]))
    one = {}
    for kind in ("qat", "adaround"):
        runner = build_runner(Config(_runner_cfg(tmp_path / f"one_{kind}", kind)),
                              ArrayLoader(batches), device="cuda")
        losses, step = [], runner.train_step
        runner.train_step = lambda *a: losses.append(step(*a)[0]) or (losses[-1], 0.0, 0)
        runner.run()
        one[kind] = ({f"{c}/{k}": t.detach().cpu() for c, f in collections(runner.model).items()
                      for k, t in f.items()}, losses, list(getattr(runner, "layer_losses", {})))
    jobs = [{"name": kind, "mesh": [2, 1], "device": "cuda", "out": str(tmp_path / kind),
             "train_runner": {"cfg": _runner_cfg(tmp_path / f"mesh_{kind}", kind),
                              "batches": str(tmp_path / "batches.npz")}}
            for kind in ("qat", "adaround")]
    reports, saved = run_jobs(2, jobs, tmp_path)
    for kind in ("qat", "adaround"):
        for key, t in saved[0][kind]["own"].items():  # data-parallel: every leaf replicated
            assert torch.equal(t, saved[1][kind]["own"][key]), (kind, key)
    calib = {"all-gather": 4, "all-reduce": 1}  # the row statistics, the masked loss
    for rep in reports:
        got = rep["qat"]
        assert got["steps"] == [calib] * 2 + [{"all-reduce": 2}] * 2
        np.testing.assert_allclose(got["losses"][:2], one["qat"][1][:2], rtol=1e-5)
        assert np.isfinite(got["losses"]).all()
        ada = rep["adaround"]
        assert list(ada["layer_losses"]) == one["adaround"][2] == ["conv1", "conv2", "fc1", "fc2"]
        assert ada["layer_losses"] == reports[0]["adaround"]["layer_losses"]
    mesh = _decisions(saved[0]["adaround"]["variables"])
    for path, (v_one, q_one) in _decisions(one["adaround"][0]).items():
        decided = v_one.abs() > 2e-2
        assert torch.equal(mesh[path][1][decided], q_one[decided]), path
