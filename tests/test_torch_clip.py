"""The CLIP slice (ViT towers) end to end: a tiny CLIP ViT W8A8 in the port,
held against the JAX package on the CPU.

``tests/test_clip.py``'s ``TINY_VIT`` (embedding 32; image tower 64 wide, 2
layers, patch 8; text tower 32 wide, 2 heads, 2 layers; vocabulary 64) with
a context of 13 tokens, so that both towers pad in packed mode (image S =
17 -> 24, text 13 -> 16), 3 classes, images 32 x 32, W8A8 (per-channel
symmetric 8-bit MinMax weights, the out-projections' ranges MSE, per-tensor
asymmetric 8-bit MinMax activations). JAX's initial variables are carried
into the port with quantize_tpu_torch.convert; its init, calibrate passes
and pack run under ``jit``, its packed passes eagerly, as the port runs its
ops.

* Variables under the flax names, ``zeroshot/weights`` (32, 3) included.
* Calibrated qparams and observer state, image tower and text tower: rtol
  1e-5 (float32 reassociation).
* fp32 logits, ``encode_text`` and ``CLIP.__call__``: rtol 1e-5 of
  max|out|; quant mode within the network's own quantization noise with
  the same argmax, as tests/test_torch_resnet.py allows.
* Zero-shot weights in fp32, calibrate and quant modes (``precompute``):
  within 1e-6 (unit vectors).
* Pack: every integer buffer bit-equal, the deploy layout JAX's (the
  ``zeroshot`` collection carried); packed image logits at f32 carry within
  1e-6 of max|logits| of JAX's packed forward (bit-equal where no int8
  rounding flips), at bf16 carry within 5e-2.
* The text tower packed through ``precompute(mode="pack")`` /
  ``precompute(mode="packed")`` against JAX's same calls: the packed
  buffers bit-equal, the embeddings within 1e-6, every attention call
  causal and on K8's plain version (``mha_rows_plain``, on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models.clip import CLIPZeroShot as JZeroShot
from quantize_tpu.models.clip import build_zeroshot as jax_build_zeroshot
from quantize_tpu.models.clip import class_prompt_tokens as jax_class_prompt_tokens
from quantize_tpu.models.clip.model import CLIP as JCLIP
from quantize_tpu.models.clip.tokenizer import HashTokenizer as JHashTokenizer
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.nn.precision import packed_carry as jax_packed_carry
import quantize_tpu_torch as qtt
import quantize_tpu_torch.ops.attention as port_attention
from quantize_tpu_torch import convert
from quantize_tpu_torch.models.clip import (CLIPZeroShot, HashTokenizer, build_zeroshot,
                                            class_prompt_tokens)
from quantize_tpu_torch.ops import launch_counts

torch.set_num_threads(2)

TINY_VIT = dict(embed_dim=32, vision_layers=2, vision_width=64, vision_patch_size=8,
                context_length=13, vocab_size=64, transformer_width=32,
                transformer_heads=2, transformer_layers=2)
W8A8 = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}
CLASSES = ["cat", "dog", "bird"]
PROMPTS = ["a photo of a {}.", "a bad photo of the {}."]


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / np.max(np.abs(b)))


def _assert_states_match(mine, theirs, cols=("qparams", "qobs"), prefix=""):
    for col in cols:
        m = {k: v for k, v in convert.flatten(mine[col]).items() if k.startswith(prefix)}
        t = {k: v for k, v in convert.flatten(theirs[col]).items() if k.startswith(prefix)}
        assert set(m) == set(t) and t, col
        for key, val in t.items():
            if key.endswith("count"):
                np.testing.assert_array_equal(m[key], val, err_msg=key)
            else:
                np.testing.assert_allclose(m[key], val, rtol=1e-5, atol=1e-7, err_msg=key)


def _record_attention(monkeypatch_calls):
    orig = port_attention.mha_rows_plain

    def rec(qkv, heads, s, causal, out_dtype, valid):
        monkeypatch_calls.append((tuple(qkv.shape), heads, s, bool(causal), valid))
        return orig(qkv, heads, s, causal, out_dtype, valid)

    return rec


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    jm = JZeroShot(backbone="ViT-B/16", num_classes=3, ctx=JaxQuantCtx(W8A8),
                   config_overrides=TINY_VIT)
    v1 = dict(jax.jit(lambda k, a: jm.init(k, a, mode="calibrate"))(
        jax.random.PRNGKey(0), jnp.asarray(x_cal)))
    v1.pop("taps", None)
    v1 = jax.device_get(v1)
    out = {"x": x}

    tm = CLIPZeroShot("ViT-B/16", 3, ctx=qtt.QuantCtx(W8A8), config_overrides=TINY_VIT,
                      image_size=32, device="cpu")
    convert.from_jax_variables(tm, {"params": v1["params"]})
    qtt.calibrate_model(tm, [x_cal], device="cpu")
    out["calibrated"] = (convert.to_numpy(tm), v1)
    out["variable_keys"] = ({c: set(convert.flatten(v)) for c, v in convert.to_numpy(tm).items()},
                            {c: set(convert.flatten(v)) for c, v in v1.items()})
    convert.from_jax_variables(tm, v1)

    jfwd = jax.jit(lambda v, a, mode: jm.apply(v, a, mode=mode), static_argnums=2)
    jtok, tok = JHashTokenizer(64), HashTokenizer(64)
    toks = class_prompt_tokens(CLASSES, PROMPTS, tok, 13)
    np.testing.assert_array_equal(toks, jax_class_prompt_tokens(CLASSES, PROMPTS, jtok, 13))
    zs = {}
    v = v1
    for mode in ("fp32", "calibrate", "quant"):
        v = jax_build_zeroshot(jm, v, CLASSES, PROMPTS, tokenizer=jtok, mode=mode)
        build_zeroshot(tm, CLASSES, PROMPTS, tokenizer=tok, mode=mode)
        zs[mode] = (tm.get_var("zeroshot", "weights").numpy().copy(),
                    np.asarray(v["zeroshot"]["weights"]))
        if mode == "calibrate":
            out["text_calibrated"] = (convert.to_numpy(tm), jax.device_get(v))
            convert.from_jax_variables(tm, jax.device_get(v))
    out["zeroshot"] = zs
    v = jax.device_get(v)
    convert.from_jax_variables(tm, v)
    with torch.no_grad():
        for mode in ("fp32", "quant"):
            out[mode] = (tm(torch.from_numpy(x), mode=mode).numpy(), np.asarray(jfwd(v, xj, mode)))
    out["noise"] = np.abs(out["quant"][1] - out["fp32"][1])

    # CLIP.__call__ and encode_text on the same variables
    jclip = JCLIP(ctx=JaxQuantCtx(W8A8), **TINY_VIT)
    cv = {c: t["clip"] for c, t in v.items() if isinstance(t, dict) and "clip" in t}
    flat = toks.reshape(-1, 13)
    for mode in ("fp32", "quant"):
        li, lt = jclip.apply(cv, xj, jnp.asarray(flat), mode=mode)
        te = jclip.apply(cv, jnp.asarray(flat), mode=mode, method=JCLIP.encode_text)
        with torch.no_grad():
            mli, mlt = tm.clip(torch.from_numpy(x), torch.from_numpy(flat), mode=mode)
            mte = tm.clip.encode_text(torch.from_numpy(flat), mode=mode)
        out[("call", mode)] = ((mli.numpy(), mlt.numpy()), (np.asarray(li), np.asarray(lt)))
        out[("text", mode)] = (mte.numpy(), np.asarray(te))

    # pack the image tower, then serve it
    deploy = jax.device_get(jax.jit(lambda vv, a: jax_pack_model(jm, vv, a))(v, xj))
    port_deploy = qtt.pack_model(tm, x, device="cpu")
    out["packed_buffers"] = (convert.flatten(convert.to_numpy(tm)["packed"]),
                             convert.flatten(deploy["packed"]))
    out["deploy"] = (port_deploy, deploy)
    before = launch_counts()
    for carry in ("float32", "bfloat16"):
        with jax_packed_carry(carry):
            want = np.asarray(jm.apply(deploy, xj, mode="packed"), np.float32)
        with qtt.packed_carry(carry), torch.no_grad():
            out[("packed", carry)] = (tm(torch.from_numpy(x), mode="packed").float().numpy(), want)

    # the text tower: pack, then the packed pass, as JAX's precompute calls
    tj = jnp.asarray(toks)
    _, upd = jax.jit(lambda vv, t: jm.apply(vv, t, mode="pack", method=JZeroShot.precompute,
                                            mutable=["packed", "zeroshot"]))(deploy, tj)
    text_deploy = jax.device_get({**deploy, **upd})
    want_emb, _ = jm.apply(text_deploy, tj, mode="packed", method=JZeroShot.precompute,
                           mutable=["zeroshot"])
    tm.precompute(toks, mode="pack")
    out["text_packed_buffers"] = (convert.flatten(convert.to_numpy(tm)["packed"]),
                                  convert.flatten(text_deploy["packed"]))
    calls = []
    orig = port_attention.mha_rows_plain
    port_attention.mha_rows_plain = _record_attention(calls)
    try:
        got_emb = tm.precompute(toks, mode="packed").numpy()
    finally:
        port_attention.mha_rows_plain = orig
    out["text_packed"] = (got_emb, np.asarray(want_emb), calls)
    out["text_quant_emb"] = zs["quant"][0].T
    out["launches_unchanged"] = launch_counts() == before
    return out


def test_variables_have_the_flax_names(case):
    mine, theirs = case["variable_keys"]
    assert mine == theirs
    assert mine["zeroshot"] == {"weights"}
    for key in ("clip/visual/conv1/kernel", "clip/visual/ln_pre/scale", "clip/visual/proj",
                "clip/visual/transformer/resblock_1/attn/out_proj/kernel",
                "clip/transformer/resblock_0/c_fc/kernel", "clip/token_embedding/embedding",
                "clip/logit_scale", "clip/text_projection", "clip/ln_final/bias"):
        assert key in mine["params"], key


def test_image_tower_calibration_matches_jax(case):
    port, theirs = case["calibrated"]
    _assert_states_match(port, theirs)


def test_text_tower_calibration_matches_jax(case):
    port, theirs = case["text_calibrated"]
    _assert_states_match(port, theirs, prefix="clip/transformer/")
    # the out-projections' weight ranges are the MSE search, not MinMax
    key = "clip/transformer/resblock_0/attn/out_proj"
    kernel = convert.flatten(port["params"])[f"{key}/kernel"]
    scale = convert.flatten(port["qparams"])[f"{key}/w_quantizer/scale"]
    assert np.any(scale < np.abs(kernel).max(0) / 127 * (1 - 1e-6))


def test_fp32_logits_match_jax(case):
    got, want = case["fp32"]
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_quant_logits_within_the_quantization_noise(case):
    got, want = case["quant"]
    noise = case["noise"]
    assert np.max(np.abs(got - want)) <= max(noise.max(), 1e-6 * np.abs(want).max())
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mode", ["fp32", "calibrate", "quant"])
def test_zeroshot_weights_match_jax(case, mode):
    got, want = case["zeroshot"][mode]
    assert got.shape == want.shape == (32, 3)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, rtol=1e-5)
    assert np.max(np.abs(got - want)) <= 1e-6


@pytest.mark.parametrize("mode", ["fp32", "quant"])
def test_encode_text_and_clip_call_match_jax(case, mode):
    got, want = case[("text", mode)]
    assert got.shape == want.shape == (6, 32)
    tol = 1e-5 if mode == "fp32" else 1e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())
    (li, lt), (wi, wt) = case[("call", mode)]
    assert li.shape == (2, 6) and lt.shape == (6, 2)
    np.testing.assert_array_equal(li.T, lt)
    np.testing.assert_allclose(li, wi, rtol=tol, atol=tol * np.abs(wi).max())
    np.testing.assert_allclose(lt, wt, rtol=tol, atol=tol * np.abs(wt).max())


def test_pack_buffers_are_bit_equal(case):
    mine, theirs = case["packed_buffers"]
    assert set(mine) == set(theirs)
    assert "clip/visual/conv1/w_int" in theirs
    assert "clip/visual/transformer/resblock_0/attn/q_proj/w_int" in theirs
    assert not any(k.startswith("clip/transformer/") for k in theirs)  # the image tower only
    for key, val in theirs.items():
        assert mine[key].dtype == np.asarray(val).dtype, key
        np.testing.assert_array_equal(mine[key], val, err_msg=key)


def test_deploy_variables_have_the_jax_layout(case):
    port, theirs = case["deploy"]
    assert {c: set(v) for c, v in port.items()} == {c: set(convert.flatten(v))
                                                     for c, v in theirs.items()}
    assert set(port["zeroshot"]) == {"weights"}
    np.testing.assert_array_equal(port["zeroshot"]["weights"].numpy(),
                                  np.asarray(theirs["zeroshot"]["weights"]))


def test_packed_image_logits_match_jax(case):
    got, want = case[("packed", "float32")]
    assert _rel(got, want) <= 1e-6
    got_bf16, want_bf16 = case[("packed", "bfloat16")]
    assert _rel(got_bf16, want_bf16) <= 5e-2
    assert _rel(got_bf16, got) <= 5e-2
    assert case["launches_unchanged"]


def test_text_tower_packs_and_serves_as_jax(case):
    mine, theirs = case["text_packed_buffers"]
    assert set(mine) == set(theirs)
    text = [k for k in theirs if k.startswith("clip/transformer/")]
    assert "clip/transformer/resblock_1/c_proj/w_int" in text
    for key, val in theirs.items():
        np.testing.assert_array_equal(mine[key], val, err_msg=key)
    got, want, calls = case["text_packed"]
    assert got.shape == want.shape == (3, 32)
    assert np.max(np.abs(got - want)) <= 1e-6
    # against quant mode: the same int8 math, within the text tower's own
    # rounding of the activations
    assert np.max(np.abs(got - case["text_quant_emb"])) <= 5e-2
    # every layer's attention on K8's plain version, causal, S 13 -> 16
    assert calls == [((6 * 16, 96), 2, 16, True, 13)] * 2
