"""CLIP's ResNet tower (ModifiedResNet + attention pooling) in the port, held
against the JAX package on the CPU.

``tests/test_clip.py``'s ``TINY_RN`` (stages 1-1-1-1 at width 8, the
attention pool 256 wide with 4 heads, embedding 32; the text tower 32 wide,
1 layer), images 64 x 64 (a 2 x 2 grid into the pool), 4 classes, W8A8 with
BN folded and unfolded (live inference BatchNorms with random statistics):
the smallest width at which the packed forward still runs every conv on
K3 and every attention-pool projection on K1. JAX's init, calibrate and
pack run under ``jit``, its packed forward eagerly.

* Calibrated qparams and observer state: rtol 1e-5.
* fp32 logits rtol 1e-5 of max|logits|; quant mode within the network's own
  quantization noise, the same argmax.
* Pack: every buffer bit-equal; the packed logits from the port's pack and
  from JAX's deploy variables equal to each other and within 1e-6 of
  max|logits| of JAX's packed forward, and within 5e-2 of quant mode (the
  JAX test's criterion); every K3, K1 and activation-quantize call on the
  plain version (19 convs, 4 projections, 23 quantizes a forward at this
  width: RN50's 55, 4 and 59).
* At bf16 carry (BN folded) the packed logits are float32, as JAX
  promotes the bf16 tower output against the float32 ``logit_scale``, and
  within 5e-2 of max|logits| of JAX's and of the f32 carry's.
* The attention pool's mean token divides by a float32 count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models.clip import CLIPZeroShot as JZeroShot
from quantize_tpu.models.clip import build_zeroshot as jax_build_zeroshot
from quantize_tpu.models.clip.tokenizer import HashTokenizer as JHashTokenizer
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.nn.precision import packed_carry as jax_packed_carry
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.models.clip import CLIPZeroShot, HashTokenizer, build_zeroshot
from quantize_tpu_torch.ops import launch_counts

torch.set_num_threads(2)

TINY_RN = dict(embed_dim=32, vision_layers=(1, 1, 1, 1), vision_width=8,
               vision_patch_size=0, context_length=16, vocab_size=64,
               transformer_width=32, transformer_heads=2, transformer_layers=1)
CLASSES = ["a", "b", "c", "d"]


def _cfg(fold):
    return {"default": {
        "weight": {"n_bits": 8, "symmetric": True, "granularity": "channel",
                   "range": {"name": "minmax"}},
        "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                       "range": {"name": "minmax"}},
        "bn_folding": fold}}


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module", params=[True, False], ids=["bnfold", "bn"])
def case(request):
    fold = request.param
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    cfg = _cfg(fold)
    jm = JZeroShot(backbone="RN50", num_classes=4, ctx=JaxQuantCtx(cfg), config_overrides=TINY_RN)
    v0 = dict(jax.jit(lambda k, a: jm.init(k, a, mode="calibrate"))(jax.random.PRNGKey(0), xj))
    v0.pop("taps", None)
    v0 = jax.device_get(v0)
    if not fold:  # non-identity BatchNorms
        v0["batch_stats"] = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32), v0["batch_stats"])
    _, upd = jax.jit(lambda v, a: jm.apply(v, a, mode="calibrate", mutable=["qobs", "qparams"]))(
        v0, jnp.asarray(x_cal))
    v1 = jax.device_get({**v0, **upd})

    tm = CLIPZeroShot("RN50", 4, ctx=qtt.QuantCtx(cfg), config_overrides=TINY_RN, image_size=64,
                      device="cpu")
    convert.from_jax_variables(tm, v0)
    qtt.calibrate_model(tm, [x_cal], device="cpu")
    out = {"fold": fold, "calibrated": (convert.to_numpy(tm), v1)}
    out["keys"] = ({c: set(convert.flatten(v)) for c, v in convert.to_numpy(tm).items()},
                   {c: set(convert.flatten(v)) for c, v in v1.items()})
    convert.from_jax_variables(tm, v1)
    # the zero-shot weights from the fp32 text tower (the runner's way)
    v = jax_build_zeroshot(jm, v1, CLASSES, tokenizer=JHashTokenizer(64))
    build_zeroshot(tm, CLASSES, tokenizer=HashTokenizer(64))
    out["zeroshot"] = (tm.get_var("zeroshot", "weights").numpy().copy(),
                       np.asarray(v["zeroshot"]["weights"]))
    v = jax.device_get(v)
    convert.from_jax_variables(tm, v)
    jfwd = jax.jit(lambda vv, a, mode: jm.apply(vv, a, mode=mode), static_argnums=2)
    with torch.no_grad():
        for mode in ("fp32", "quant"):
            out[mode] = (tm(torch.from_numpy(x), mode=mode).numpy(), np.asarray(jfwd(v, xj, mode)))
    out["noise"] = np.abs(out["quant"][1] - out["fp32"][1])
    deploy = jax.device_get(jax.jit(lambda vv, a: jax_pack_model(jm, vv, a))(v, xj))
    qtt.pack_model(tm, x, device="cpu")
    out["packed_buffers"] = (convert.flatten(convert.to_numpy(tm)["packed"]),
                             convert.flatten(deploy["packed"]))
    fresh = CLIPZeroShot("RN50", 4, ctx=qtt.QuantCtx(cfg), config_overrides=TINY_RN,
                         image_size=64, device="cpu")
    convert.from_jax_variables(fresh, deploy)
    before = launch_counts()
    with torch.no_grad(), chip_smoke.Recorder() as rec:
        got = tm(torch.from_numpy(x), mode="packed").numpy()
    with torch.no_grad():
        got_fresh = fresh(torch.from_numpy(x), mode="packed").numpy()
    out["calls"] = {name: sum(c for _, c in calls.values()) for name, calls in rec.calls.items()}
    out["packed"] = (got, got_fresh, np.asarray(jm.apply(deploy, xj, mode="packed")))
    if fold:  # the bf16 carry: the tower's output is bf16, the logits float32
        with jax_packed_carry("bfloat16"):
            want = np.asarray(jm.apply(deploy, xj, mode="packed"), np.float32)
        with qtt.packed_carry("bfloat16"), torch.no_grad():
            bf16 = tm(torch.from_numpy(x), mode="packed")
        out["bf16"] = (bf16.dtype, bf16.numpy(), want)
    out["launches_unchanged"] = launch_counts() == before
    out["model"], out["x"] = tm, x
    return out


def test_variables_have_the_flax_names(case):
    mine, theirs = case["keys"]
    assert mine == theirs
    params = mine["params"]
    for key in ("clip/visual/conv3/kernel", "clip/visual/layer4_0/downsample_conv/kernel",
                "clip/visual/attnpool/positional_embedding", "clip/visual/attnpool/c_proj/kernel"):
        assert key in params, key
    assert ("clip/visual/layer2_0/bn2/BatchNorm_0/scale" in params) is not case["fold"]
    assert ("batch_stats" in mine) is not case["fold"]


def test_calibration_matches_jax(case):
    port, theirs = case["calibrated"]
    for col in ("qparams", "qobs"):
        mine, want = convert.flatten(port[col]), convert.flatten(theirs[col])
        assert set(mine) == set(want), col
        for key, val in want.items():
            if key.endswith("count"):
                np.testing.assert_array_equal(mine[key], val, err_msg=key)
            else:
                np.testing.assert_allclose(mine[key], val, rtol=1e-5, atol=1e-7, err_msg=key)


def test_fp32_and_quant_logits_match_jax(case):
    got, want = case["fp32"]
    assert got.shape == want.shape == (2, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    got, want = case["quant"]
    noise = case["noise"]
    assert np.max(np.abs(got - want)) <= max(noise.max(), 1e-6 * np.abs(want).max())
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    zs, zs_want = case["zeroshot"]
    assert np.max(np.abs(zs - zs_want)) <= 1e-6


def test_pack_buffers_are_bit_equal(case):
    mine, theirs = case["packed_buffers"]
    assert set(mine) == set(theirs)
    assert "clip/visual/attnpool/q_proj/w_int" in theirs
    assert "clip/visual/layer1_0/downsample_conv/corr_a" in theirs
    for key, val in theirs.items():
        assert mine[key].dtype == np.asarray(val).dtype, key
        np.testing.assert_array_equal(mine[key], val, err_msg=key)


def test_packed_logits_match_jax_and_quant_mode(case):
    got, got_fresh, want = case["packed"]
    np.testing.assert_array_equal(got, got_fresh)
    assert _rel(got, want) <= 1e-6
    np.testing.assert_allclose(got, case["quant"][0], rtol=5e-2, atol=5e-2)
    assert case["calls"]["qconv2d"] == 19 and case["calls"]["w8a8_gemm"] == 4
    assert case["calls"]["quantize_act_int8"] == 23
    assert sum(case["calls"].values()) == 19 + 4 + 23
    assert case["launches_unchanged"]
    if case["fold"]:  # the bf16 carry: float32 logits, as JAX promotes them
        dtype, got_bf16, want_bf16 = case["bf16"]
        assert dtype == torch.float32
        assert _rel(got_bf16, want_bf16) <= 5e-2 and _rel(got_bf16, got) <= 5e-2


def test_attention_pool_mean_divides_by_a_float32_count(case, monkeypatch):
    """The mean token is a float32 sum divided by a float32 tensor count
    (a CUDA ``Tensor.mean`` multiplies by the reciprocal)."""
    calls = []
    orig = torch.Tensor.__truediv__

    def div(a, b):
        calls.append(b if isinstance(b, torch.Tensor) else type(b))
        return orig(a, b)

    monkeypatch.setattr(torch.Tensor, "__truediv__", div)
    with torch.no_grad():
        case["model"].clip.visual.attnpool(torch.ones((1, 2, 2, 256)), mode="fp32")
    assert calls and all(isinstance(c, torch.Tensor) and c.dtype == torch.float32 for c in calls)
    assert float(calls[0]) == 4.0

