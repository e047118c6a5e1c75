"""Blockwise and sequential AdaRound: the port's runner against the JAX
package's on the CPU, TestCNN (16 x 16, BN folded) with the AdaRound base
config's quant section (W4 per-channel symmetric MinMax weights with
``adaround.apply``, 32-bit activations), Adam lr 1e-3, β dynamic, 3
batches of 8, ``max_epoch`` 2 (6 steps a layer), both runners from JAX's
initial variables.

At ``tests/test_golden_traj.py``'s AdaRound criteria:

* the layers reconstructed, in the order of their first call;
* final V on the active sigmoid region (|V| < 2.2 on both sides): at least
  60% of V active, 97% of the pooled differences within 5e-3, none above
  0.05;
* rounding DECISIONS exact wherever JAX's |V| > 2e-2. The decision is the
  integer each weight rounds to (floor(w/s - z) + [h(V) >= 0.5]), not the
  sign of V: JAX's runner computes the MinMax scale under ``jit``, where XLA
  multiplies by the reciprocal of qmax, an ulp from the true quotient the
  port takes, so that each channel's extreme weight (exactly on the grid)
  sits an ulp below the integer there, with V initialized to the opposite
  sign, and rounds to the same integer.

The runners' qparams agree within rtol 1e-5, and the port's checkpoint
holds ``adaround`` and reloads bit-equal.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.runners.adaround import AdaRound as JaxAdaRound
from quantize_tpu.utils import Config as JaxConfig
from quantize_tpu_torch import convert
from quantize_tpu_torch.quant.adaround import rect_sigmoid
from quantize_tpu_torch.runners import build_runner
from quantize_tpu_torch.runners.adaround import AdaRound
from quantize_tpu_torch.utils import Config

torch.set_num_threads(2)

QUANT = {"default": {
    "weight": {"n_bits": 4, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax", "percentile": 0.0}, "adaround": {"apply": True}},
    "activation": {"n_bits": 32, "range": {"name": "minmax"}},
    "bn_folding": True}}


class _Loader:
    def __init__(self, batches):
        self.batches, self.batch_size = batches, len(batches[0]["label"])

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _cfg(out, mode):
    return {"seed": 0, "output_dir": str(out), "model": {"name": "testcnn", "num_classes": 10},
            "runner": {"name": "adaround", "reconstruction": mode, "beta": "dynamic"},
            "quant": QUANT, "train": {"max_epoch": 2, "print_freq": 1000},
            "optimizer": {"name": "adam", "lr": 1e-3}, "lr_scheduler": {"name": "constant"}}


@pytest.fixture(scope="module", params=["blockwise", "sequential"])
def runs(request, tmp_path_factory):
    mode = request.param
    rng = np.random.default_rng(3)
    batches = [{"img": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 8).astype(np.int32)} for _ in range(3)]
    jr = JaxAdaRound(JaxConfig(_cfg(tmp_path_factory.mktemp("jax"), mode)), _Loader(batches))
    jr.init_variables(batches[0], seed=0)
    v0 = dict(jr.variables)
    jr.run()
    order = ["/".join(p) for p in jr._collect_layer_clones(jnp.asarray(batches[0]["img"]))]
    cfg = Config(_cfg(tmp_path_factory.mktemp("port"), mode))
    pr = build_runner(cfg, _Loader(batches), device="cpu")
    assert isinstance(pr, AdaRound)
    pr.variables = v0
    pr.run()
    return {"mode": mode, "jax": convert.flatten(jax.device_get(jr.variables)),
            "port": convert.flatten(convert.to_numpy(pr.model)), "runner": pr, "cfg": cfg,
            "order": order}


def test_every_layer_in_call_order(runs):
    assert list(runs["runner"].layer_losses) == runs["order"] == ["conv1", "conv2", "fc1", "fc2"]
    assert all(np.isfinite(v) for v in runs["runner"].layer_losses.values())


def _v_and_q(flat, layer):
    """V and the integer each weight rounds to."""
    v = flat[f"adaround/{layer}/w_quantizer/V"]
    w_over = (flat[f"params/{layer}/kernel"] / flat[f"qparams/{layer}/w_quantizer/scale"]
              - flat[f"qparams/{layer}/w_quantizer/zero"])
    h = rect_sigmoid(torch.tensor(v)).numpy()
    return v.reshape(-1), (np.floor(w_over) + (h >= 0.5)).reshape(-1)


def test_final_v_and_decisions_match_jax(runs):
    diffs, n_checked = [], 0
    for layer in runs["order"]:
        v_j, q_j = _v_and_q(runs["jax"], layer)
        v_t, q_t = _v_and_q(runs["port"], layer)
        active = (np.abs(v_j) < 2.2) & (np.abs(v_t) < 2.2)
        assert active.mean() > 0.6, f"{layer}: most V elements must stay active"
        diffs.append(np.abs(v_t[active] - v_j[active]))
        decided = np.abs(v_j) > 2e-2
        assert np.array_equal(q_t[decided], q_j[decided]), (
            f"{layer}: {(q_t[decided] != q_j[decided]).sum()} rounding decisions diverge")
        n_checked += decided.sum()
    assert n_checked > 1000
    diff = np.concatenate(diffs)
    assert (diff <= 5e-3).mean() >= 0.97 and diff.max() <= 0.05, (
        f"final V (active, pooled): {(diff > 5e-3).sum()}/{diff.size} beyond 5e-3, "
        f"max {diff.max():.4g}")


def test_qparams_match_jax(runs):
    for key, want in runs["jax"].items():
        if key.startswith("qparams/"):
            np.testing.assert_allclose(runs["port"][key], want, rtol=1e-5, atol=1e-7,
                                       err_msg=key)


def test_checkpoint_holds_adaround_and_reloads_bit_equal(runs):
    fresh = build_runner(runs["cfg"], device="cpu")
    fresh.load_checkpoint(str(Path(runs["cfg"].output_dir) / "ckpt_last.pkl"))
    got = convert.flatten(convert.to_numpy(fresh.model))
    assert any(k.startswith("adaround/") for k in got)
    assert set(got) == set(runs["port"])
    for key, want in runs["port"].items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
