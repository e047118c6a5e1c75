"""Phase 12b/12c of ``chip_smoke.py`` at a tiny width, on the card: one
sharded QAT step of ResNet-18 W8A8 (32 px, 16 classes, the QAT configs'
activations) on two ranks sharing the card over gloo, at ``(2, 1)`` and
``(1, 2)`` (``tests/_torch_mesh.py``'s worker with ``device="cuda"``).

Held: the loss finite and within 1e-2 relative of the one-device step on
the card (a split batch or a split layer changes cuDNN's sums, which can
move an int8 activation step: the bound is the quantization noise, not
f32's), the ranks' variables bit-equal after the step, and the step's
collectives exactly those of the CPU tests. This file imports no JAX, so
it runs on the card's machine with ``--noconftest``; here the ``cuda``
marker's tests skip.
"""
import numpy as np
import pytest
import torch

from _torch_mesh import run_jobs

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
