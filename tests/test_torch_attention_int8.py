"""The int8-scores attention (kernel K9) and the attention shape dispatch of
the port against the JAX package on the CPU.

* K9's plain version vs the Pallas ``_mha_rows_int8_kernel`` in interpret
  mode (``mha_fused_qkv_rows(..., int8_scores=True)``). Both quantize with
  the same true divisions and round half to even, sum integers exactly and
  run the same float32 epilogue, so they agree bit for bit except where the
  two frameworks' ``exp`` differ by an ulp at a point where
  ``exp(s - m) * 127`` lies on a rounding boundary: that flips one ex8 by one
  step and moves one output row of one head. The test counts the output
  elements that differ, asserts at most 2 flipped rows per case (seen: 0),
  and bounds each such difference by what one step can do, 2.05 * sv
  (``out = av * sv / norm`` with ``norm >= 127``).
* The pad rows of the padded block (rows past ``valid_len``) carry non-zero
  values here: the per-(image, head) absmax runs over all S rows in both.
* Shapes the JAX package's Pallas kernels do not take (head dim or S not a
  multiple of 8, a VMEM estimate above 12 MB) run JAX's float32 oracle in
  both packages, and neither K8 nor K9 is launched.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.ops.pallas import attention as jattn
from quantize_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _f32(t):
    return t.float().numpy()


def _padded_rows(b, s, h, d, valid, seed):
    """(B*S, 3E) rows: valid rows unit-normal, pad rows non-zero and larger
    (they set some of the absmax scales)."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, s, 3 * h * d)).astype(np.float32)
    if valid:
        qkv[:, valid:] = rng.normal(scale=3.0, size=(b, s - valid, 3 * h * d))
    return qkv.reshape(b * s, 3 * h * d)


def _sv(rows, b, s, h, d):
    """K9's v scale of each (image, head): absmax over all S rows / 127."""
    v = np.abs(rows.reshape(b, s, 3, h, d)[:, :, 2].astype(np.float32))
    return np.maximum(v.max(axis=(1, 3)), 1e-12) / np.float32(127.0)  # (B, H)


def _check_flips(got, want, b, s, h, d, sv, max_rows=2):
    """Bit-equal but for whole (row, head) groups moved by an ex8 flip."""
    got, want = _f32(got).reshape(b, s, h, d), np.asarray(want, np.float32).reshape(b, s, h, d)
    assert np.isfinite(got).all()
    diff = np.abs(got.astype(np.float64) - want)
    rows = np.argwhere(diff.max(axis=-1) > 0)
    assert len(rows) <= max_rows, f"{len(rows)} (row, head) groups differ"
    for bi, _, hi in rows:
        # one step of ex8 moves out = av * sv / norm by at most 2.05 * sv
        # (plus one bf16 rounding of the output for a bf16 result)
        assert diff[bi, :, hi].max() <= 2.05 * sv[bi, hi] * (1 + 2.0 ** -7)
    return len(rows)


@pytest.mark.parametrize("b,s,h,d,valid,causal", [(2, 16, 2, 16, 0, False),
                                                  (2, 16, 2, 32, 11, True),
                                                  (2, 56, 2, 64, 50, False),
                                                  (2, 56, 2, 64, 50, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_plain_matches_the_pallas_kernel(b, s, h, d, valid, causal, dtype):
    rows = _padded_rows(b, s, h, d, valid, seed=s + d + valid)
    xj, xt = jnp.asarray(rows).astype(dtype), _t(rows).to(getattr(torch, dtype))
    rows_in = np.asarray(xj.astype(jnp.float32))
    want = jattn.mha_fused_qkv_rows(xj, h, s, causal=causal, valid_len=valid, int8_scores=True)
    got = tattn.mha_rows_int8_plain(xt, h, s, causal, xt.dtype, valid)
    assert got.dtype == xt.dtype and tuple(got.shape) == (b * s, h * d)
    _check_flips(got, want, b, s, h, d, _sv(rows_in, b, s, h, d))


def test_int8_pad_rows_move_the_scales():
    """Zeroing the pad rows changes the answer: the absmax (and so every
    int8 value of a head) includes them, as the Pallas block does."""
    b, s, h, d, valid = 2, 56, 2, 64, 50
    rows = _padded_rows(b, s, h, d, valid, seed=4)
    clean = rows.reshape(b, s, -1).copy()
    clean[:, valid:] = 0.0
    clean = clean.reshape(b * s, -1)
    with_pads = tattn.mha_rows_int8_plain(_t(rows), h, s, False, torch.float32, valid).numpy()
    without = tattn.mha_rows_int8_plain(_t(clean), h, s, False, torch.float32, valid).numpy()
    keep = np.arange(b * s) % s < valid
    assert np.abs(with_pads[keep] - without[keep]).max() > 1e-3
    want = np.asarray(jattn.mha_fused_qkv_rows(jnp.asarray(rows), h, s, valid_len=valid,
                                               int8_scores=True))
    _check_flips(_t(with_pads), want, b, s, h, d, _sv(rows, b, s, h, d))


def test_int8_close_to_the_float_attention():
    """tests/test_attention_kernel.py's int8-noise band for the variant:
    within 5e-2 of the float32 oracle at S = 200, valid 197."""
    b, s, h, d, valid = 1, 200, 2, 64, 197
    rows = _padded_rows(b, s, h, d, 0, seed=7)
    got = tattn.mha_rows_int8_plain(_t(rows), h, s, False, torch.float32, valid).numpy()
    ref = tattn.mha_oracle_rows(_t(rows), h, s, False, torch.float32, valid).numpy()
    assert np.abs(got - ref).max() <= 5e-2


def _spy_kernels(monkeypatch):
    called = []
    for name in ("mha_rows", "mha_rows_int8"):
        orig = getattr(tattn, name)

        def spy(*a, _orig=orig, _name=name):
            called.append(_name)
            return _orig(*a)

        monkeypatch.setattr(tattn, name, spy)
    return called


@pytest.mark.parametrize("env,arg,want", [(None, None, "mha_rows"), ("0", None, "mha_rows"),
                                          ("1", None, "mha_rows_int8"),
                                          ("1", False, "mha_rows"),
                                          (None, True, "mha_rows_int8")])
def test_int8_switch(monkeypatch, env, arg, want):
    """``int8_scores=None`` reads QTPU_ATTN_INT8 at call time, as JAX's
    ``_int8_scores_default``; an explicit argument wins."""
    if env is None:
        monkeypatch.delenv("QTPU_ATTN_INT8", raising=False)
    else:
        monkeypatch.setenv("QTPU_ATTN_INT8", env)
    called = _spy_kernels(monkeypatch)
    rows = _padded_rows(2, 16, 2, 16, 0, seed=2)
    out = tattn.mha_fused_qkv_rows(_t(rows), 2, 16, valid_len=13, int8_scores=arg)
    assert called == [want]
    plain = tattn.mha_rows_int8_plain if want == "mha_rows_int8" else tattn.mha_rows_plain
    np.testing.assert_array_equal(out.numpy(),
                                  plain(_t(rows), 2, 16, False, torch.float32, 13).numpy())


@pytest.mark.parametrize("int8", [False, True])
def test_head_dim_not_a_multiple_of_8_runs_the_oracle(monkeypatch, int8):
    """bf16 qkv with head dim 12: the JAX package sends it to its float32
    oracle ``_mha_ref`` (attention.py:260-261), and so does the port, without
    launching K8 or K9. Both compute in float32 and round the output to bf16
    once: at most one bf16 ulp apart (seen: equal). K8's arithmetic (bf16
    products) gives a visibly different answer here."""
    b, s, h, d, valid = 2, 24, 2, 12, 19
    rows = _padded_rows(b, s, h, d, 0, seed=12)
    xj = jnp.asarray(rows).astype(jnp.bfloat16)
    xt = _t(rows).to(torch.bfloat16)
    want = np.asarray(jattn.mha_fused_qkv_rows(xj, h, s, valid_len=valid, int8_scores=int8),
                      np.float32)
    called = _spy_kernels(monkeypatch)
    assert not tattn.kernel_takes(xt, h, s, False, valid)
    got = tattn.mha_fused_qkv_rows(xt, h, s, valid_len=valid, int8_scores=int8)
    assert called == [] and got.dtype == torch.bfloat16
    g = _f32(got)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(g), np.abs(want)).clip(1e-30))) - 7)
    assert np.all(np.abs(g - want) <= ulp)
    k8 = _f32(tattn.mha_rows_plain(xt, h, s, False, torch.bfloat16, valid))
    assert np.abs(k8 - want).max() > 4 * np.abs(g - want).max() + 1e-3


def test_sequence_not_a_multiple_of_8_runs_the_oracle(monkeypatch):
    """S = 13 given directly as rows (the 3-D wrapper would pad it): the
    oracle in both packages, rtol 1e-5 / atol 1e-5 (float32 sums)."""
    rows = _padded_rows(2, 13, 2, 16, 0, seed=13)
    want = np.asarray(jattn.mha_fused_qkv_rows(jnp.asarray(rows), 2, 13, causal=True))
    called = _spy_kernels(monkeypatch)
    got = tattn.mha_fused_qkv_rows(_t(rows), 2, 13, causal=True)
    assert called == []
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_vmem_estimate_sends_vit_h_at_f32_to_the_oracle(monkeypatch):
    """ViT-H/14 at f32 carry (S = 264, E = 1280, 16 heads): JAX's VMEM
    estimate is 13.1 MB (12.5 MiB), above its 12 MiB budget, so the oracle
    runs; at bf16 carry (10.4 MB) and for ViT-B (S = 200, E = 768) the kernel.
    One image, rtol 1e-5 / atol 1e-5 against JAX."""
    s, e, h = 264, 1280, 16
    rows = _padded_rows(1, s, h, e // h, 257, seed=14)
    assert not tattn.kernel_takes(_t(rows), h, s, False, 257)
    assert tattn.kernel_takes(_t(rows).to(torch.bfloat16), h, s, False, 257)
    assert tattn.kernel_takes(torch.zeros(200, 3 * 768), 12, 200, False, 197)
    want = np.asarray(jattn.mha_fused_qkv_rows(jnp.asarray(rows), h, s, valid_len=257))
    called = _spy_kernels(monkeypatch)
    got = tattn.mha_fused_qkv_rows(_t(rows), h, s, valid_len=257)
    assert called == []
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
