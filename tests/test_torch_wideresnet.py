"""WideResNet-10-2 (the pre-activation CIFAR WRN) in the port, held against
the JAX package on the CPU (batch 2, 32 x 32, 10 classes).

The fold topology is the reference's, as JAX reproduces it: with
``bn_folding`` each block's ``bn2`` folds into ``conv1`` and its ``bn1``
stays a live BatchNorm (random running statistics here, so that it
counts), ``conv2`` and the shortcut unfolded. W8A8 through
``tests/_torch_parity.py``: fp32 logits at rtol 1e-4, calibrated qparams
at rtol 1e-5, quant logits within the quantization noise with the same
argmax, pack buffers bit-equal and the packed logits (every conv on K3's
plain version, the head on K1's) bit-equal to eager JAX's. Unfolded, the
float network (both BatchNorms live) matches JAX's at rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.models.wideresnet import WideResNet as JaxWideResNet
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.models.wideresnet import WideResNet

from _torch_parity import check_calibrated, check_fp32_and_quant, check_packed, run_both

torch.set_num_threads(2)

W8 = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
      "range": {"name": "minmax"}}
A8 = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}
KW = {"depth": 10, "widen_factor": 2}


def _random_stats(tree, seed=11):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "mean":
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    return run_both((JaxWideResNet, WideResNet), {"default": {"weight": W8, "activation": A8,
                                                 "bn_folding": True}},
                    x, x_cal, KW, batch_stats=_random_stats)


def test_wrn_fold_topology_keeps_bn1_live():
    ctx = qtt.QuantCtx({"default": {"weight": W8, "activation": A8, "bn_folding": True}})
    model = WideResNet(num_classes=10, ctx=ctx, device="cpu", **KW)
    stats = convert.flatten(convert.to_numpy(model)["batch_stats"])
    for b in ("block1_0", "block2_0", "block3_0"):
        assert f"{b}/bn1/BatchNorm_0/mean" in stats and not any(k.startswith(f"{b}/bn2")
                                                                 for k in stats)
        assert not hasattr(getattr(model, b), "bn2")
    assert "bn1/BatchNorm_0/var" in stats  # the top-level BatchNorm
    # 1 stem + 2 per block + 3 shortcuts
    convs = [m for m in model.modules() if isinstance(m, qtt.QuantConv)]
    assert len(convs) == 1 + 2 * 3 + 3


def test_wrn_calibrates_as_jax(case):
    check_calibrated(case)


def test_wrn_fp32_and_quant_logits_match_jax(case):
    check_fp32_and_quant(case)


def test_wrn_packs_and_serves_as_jax(case):
    check_packed(case)


def test_wrn_unfolded_fp32_matches_jax():
    rng = np.random.default_rng(41)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JaxWideResNet(num_classes=10, **KW)
    v = jax.device_get(dict(jax.jit(lambda k, a: jm.init(k, a, mode="fp32"))(
        jax.random.PRNGKey(1), jnp.asarray(x))))
    v["batch_stats"] = _random_stats(v["batch_stats"], seed=12)
    tm = WideResNet(num_classes=10, device="cpu", **KW)
    convert.from_jax_variables(tm, v)
    stats = convert.flatten(convert.to_numpy(tm)["batch_stats"])
    assert set(stats) == set(convert.flatten(v["batch_stats"]))
    assert any("/bn2/" in k for k in stats)  # unfolded: both BatchNorms live
    want = np.asarray(jm.apply(v, jnp.asarray(x), mode="fp32"))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mode="fp32").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
