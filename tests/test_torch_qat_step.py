"""One QAT step in the port against the JAX package's QAT runner on the
CPU (``tests/_torch_train_parity.py``): TestCNN W8A8 with its BatchNorms
live and folded, a tiny ViT W4A8 and MobileNetV2 (width 0.25) W8A8 with BN
folded, activations ``maminmax`` as the QAT configs set them.

The trainable leaves are JAX's ``TRAINABLE`` tree (``params`` and every
``qparams`` leaf); the masked cross-entropy within rtol 1e-5, the logits
within 1e-5 of max|logits|, and each leaf's gradient with at least 99% of
its elements within rtol 1e-4 plus atol 1e-6 (for a ``qparams`` leaf plus
1e-3 of its largest entry) and the difference's L2 norm within 1e-3 of the
gradient's plus 1e-6 * sqrt(n) (``check_grad`` says why).
"""
import numpy as np
import pytest
import torch

from _torch_train_parity import (A8, W4, W8, check_grad, flat_keys, jax_qat_step, quant_cfg,
                                 setup, to_torch)
from quantize_tpu_torch import convert
from quantize_tpu_torch.runners.qat import TRAINABLE, loss_and_grads

torch.set_num_threads(2)

CASES = {"testcnn-bn": W8, "testcnn-bnfold": W8, "vit": W4, "mobilenet_v2": W8}


@pytest.fixture(scope="module", params=sorted(CASES))
def step(request):
    name = request.param
    jm, tm, v, x, label = setup(name, quant_cfg(name, CASES[name], A8))
    want = jax_qat_step(jm, v, x, label)
    got = loss_and_grads(tm, to_torch(x), to_torch(label))
    return {"name": name, "jax": want, "port": got, "variables": v, "model": tm}


def test_trainable_leaves_are_jax_trainable_tree(step):
    _, _, grads = step["port"]
    want = flat_keys(step["variables"], TRAINABLE)
    assert set(grads) == want
    assert any(k.startswith("qparams/") for k in grads) and any(
        k.endswith("/w_quantizer/scale") for k in grads)
    if step["name"] == "testcnn-bn":
        assert "params/bn1/BatchNorm_0/scale" in grads
        assert not any(k.startswith("batch_stats") for k in grads)


def test_loss_and_logits_match_jax(step):
    loss_j, logits_j, _ = step["jax"]
    loss_t, logits_t, _ = step["port"]
    np.testing.assert_allclose(float(loss_t), loss_j, rtol=1e-5)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, rtol=0,
                               atol=1e-5 * np.abs(logits_j).max())


def test_gradients_match_jax(step):
    _, _, grads_j = step["jax"]
    _, _, grads_t = step["port"]
    flat_j = {f"{c}/{k}": a for c in grads_j for k, a in convert.flatten(grads_j[c]).items()}
    nonzero = 0
    for key, want in flat_j.items():
        got = grads_t[key]
        got = np.zeros_like(want) if got is None else got.numpy()
        check_grad(got, want, key)
        nonzero += bool(np.any(want))
    assert nonzero >= len(flat_j) // 2
