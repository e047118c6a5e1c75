"""Parity of the port's ViT-slice ops with the JAX package on the CPU: the
split-half int4 packing, the plain versions of kernels K4 (W4A8 GEMM), K6
(LayerNorm), K7 (LayerNorm + int8 quantize) and K8 (row-layout attention),
and the weight-only product. The same numpy inputs go through both.

Where the JAX function reaches a Pallas kernel it runs in interpret mode,
as the JAX package's own tests run it: ``set_matmul_backend("pallas")``
for ``_w4a8_kernel``, d = 128 for the LayerNorm kernels, S and d multiples
of 8 for the attention kernel. Tolerances are stated at each test.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu_torch.ops import attention as tattn
from quantize_tpu_torch.ops import launch_counts
from quantize_tpu_torch.ops import layernorm as tln
from quantize_tpu_torch.ops import qmatmul as tqm

torch.set_num_threads(2)

# the modules themselves (quantize_tpu re-exports functions of the same names)
jattn = importlib.import_module("quantize_tpu.ops.pallas.attention")
jln = importlib.import_module("quantize_tpu.ops.pallas.layernorm")
jqm = importlib.import_module("quantize_tpu.ops.pallas.qmatmul")


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bf16_ulps(got, want):
    """|got - want| in units of one bf16 ulp of the larger magnitude."""
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    return np.max(np.abs(got - want) / ulp)


# ---------------------------------------------------------------------------
# split-half int4 packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(8, 5), (64, 48), (6, 1)])
def test_pack_int4_splithalf_is_bit_equal_to_jax_and_round_trips(k, n):
    q = np.random.default_rng(k).integers(-8, 8, size=(k, n)).astype(np.int8)
    q[0, 0], q[-1, -1] = -8, 7  # the grid's ends
    want = np.asarray(jqm.pack_int4_splithalf(jnp.asarray(q)))
    got = tqm.pack_int4_splithalf(_t(q))
    assert got.dtype == torch.int8 and tuple(got.shape) == (k // 2, n)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tqm.unpack_int4_splithalf(got)
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jqm.unpack_int4_splithalf(jnp.asarray(want))))


def test_pack_int4_splithalf_rejects_odd_k():
    q = np.zeros((5, 3), np.int8)
    with pytest.raises(AssertionError):
        jqm.pack_int4_splithalf(jnp.asarray(q))
    with pytest.raises(ValueError, match="even"):
        tqm.pack_int4_splithalf(_t(q))


# ---------------------------------------------------------------------------
# K4: quant_matmul_w4a8
# ---------------------------------------------------------------------------

def _w4_case(m, k, n, sym_w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.integers(-8, 8, size=(k, n)).astype(np.int8)
    w_scale = rng.uniform(0.01, 0.1, size=(n,)).astype(np.float32)
    w_zero = (np.zeros((n,), np.float32) if sym_w
              else rng.uniform(-2, 2, size=(n,)).astype(np.float32))
    bias = rng.normal(size=(n,)).astype(np.float32)
    return x, w, w_scale, w_zero, bias


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(32, 64, 48), (20, 40, 24), (9, 200, 10)])
@pytest.mark.parametrize("sym_w", [True, False])
@pytest.mark.parametrize("grid", [(0, 255), (-128, 127)])
def test_w4a8_plain_matches_jax(backend, shape, sym_w, grid):
    """Against both JAX backends. The XLA branch runs eagerly (op by op), so
    the port is bit-equal to it: exact integer sums, the same float32
    epilogue. ``_w4a8_call`` ("pallas", interpret mode) is jitted, and XLA
    on the CPU contracts its epilogue into FMAs (ROADMAP.md section 3), one
    rounding per fused op: rtol 1e-6 / atol 1e-6 (seen: one ulp). With a
    zero bias and zero points its epilogue has no add to contract, and the
    port is bit-equal to it as well: the half-K pairing of the int4 nibbles
    and the column sums are exact. K = 40 and 200 give K/2 = 20 and 100,
    not multiples of 32."""
    x, w, w_s, w_z, b = _w4_case(*shape, sym_w=sym_w, seed=sum(shape))
    qmin, qmax = grid
    a_s = np.float32((x.max() - x.min()) / 255.0)
    a_z = np.float32(x.min() / a_s) if qmin == 0 else np.float32(0.0)
    wp = np.asarray(jqm.pack_int4_splithalf(jnp.asarray(w)))

    def both(a_z, w_z, b):
        prev = jqm.matmul_backend()
        jqm.set_matmul_backend(backend)
        try:
            want = np.asarray(jqm.quant_matmul_w4a8(
                jnp.asarray(x), a_s, a_z, qmin, qmax, jnp.asarray(wp), jnp.asarray(w_s),
                jnp.asarray(w_z), jnp.asarray(b), w_zero_is_zero=sym_w))
        finally:
            jqm.set_matmul_backend(prev)
        got = tqm.quant_matmul_w4a8(_t(x), _t(a_s), _t(a_z), qmin, qmax, _t(wp), _t(w_s),
                                    _t(w_z), _t(b), w_zero_is_zero=sym_w)
        return got.numpy(), want

    before = launch_counts()
    got, want = both(a_z, w_z, b)
    assert launch_counts() == before
    if backend == "xla":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        if sym_w and qmin < 0:
            got, want = both(np.float32(0.0), w_z, np.zeros_like(b))
            np.testing.assert_array_equal(got, want)


def test_w4a8_with_pre_quantized_input_and_pack_time_col_sum():
    x, w, w_s, w_z, b = _w4_case(16, 96, 32, sym_w=True, seed=3)
    a_s, a_z = np.float32(0.02), np.float32(-60.0)
    wp = tqm.pack_int4_splithalf(_t(w))
    col_sum = _t(w).sum(0, dtype=torch.int32)
    q, z = tqm.quantize_act_int8(_t(x), _t(a_s), _t(a_z), 0, 255)
    got = tqm.quant_matmul_w4a8(_t(x), _t(a_s), _t(a_z), 0, 255, wp, _t(w_s), _t(w_z), _t(b),
                                col_sum, w_zero_is_zero=True, pre_q=(q, z))
    want = tqm.quant_matmul_w8a8(_t(x), _t(a_s), _t(a_z), 0, 255, _t(w), _t(w_s), _t(w_z), _t(b),
                                 w_zero_is_zero=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# weight-only product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k4", [False, True])
def test_quant_matmul_wo_matches_jax(k4):
    """f32 on the CPU in both packages; XLA and oneDNN sum the products in
    another order, so rtol 1e-5 / atol 1e-5."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    lo, hi = (-8, 8) if k4 else (-128, 128)
    w = rng.integers(lo, hi, size=(64, 24)).astype(np.int8)
    w_s = rng.uniform(0.001, 0.05, size=(24,)).astype(np.float32)
    w_z = rng.uniform(-2, 2, size=(24,)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = np.asarray(jqm.quant_matmul_wo(jnp.asarray(x), jnp.asarray(w), jnp.asarray(w_s),
                                          jnp.asarray(w_z), jnp.asarray(b)))
    got = tqm.quant_matmul_wo(_t(x), _t(w), _t(w_s), _t(w_z), _t(b))
    assert tuple(got.shape) == want.shape == (3, 5, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tqm._dequant_weight(_t(w), _t(w_s), _t(w_z)).numpy(),
        np.asarray(jqm._dequant_weight(jnp.asarray(w), jnp.asarray(w_s), jnp.asarray(w_z))))


def test_quant_matmul_wo_raises_for_awq_and_groups():
    w = torch.zeros((8, 4), dtype=torch.int8)
    for kw in ({"awq_recip": torch.ones(8)}, {"group_size": 4}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tqm.quant_matmul_wo(torch.zeros(2, 8), w, torch.ones(4), torch.zeros(4), **kw)


# ---------------------------------------------------------------------------
# K6 / K7: layernorm, layernorm_quant_int8
# ---------------------------------------------------------------------------

def _ln_case(r, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(r, d)) * 2.5 + 0.7).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=(d,)).astype(np.float32)
    b = rng.normal(scale=0.2, size=(d,)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 48])
def test_layernorm_plain_matches_jax(dtype, d):
    """d = 128 runs JAX's ``_ln_kernel`` (interpret mode), d = 48 its jnp
    fallback. f32 output: rtol 1e-5 / atol 1e-5 (the statistics differ by
    float32 reassociation); a bf16 output rounds the same f32 values, so at
    most one bf16 ulp apart."""
    x, g, b = _ln_case(40, d, seed=d)
    xj, xt = jnp.asarray(x), _t(x)
    if dtype == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    for out in ("float32", "bfloat16"):
        want = np.asarray(jln.layernorm(xj, jnp.asarray(g), jnp.asarray(b), 1e-6,
                                        out_dtype=getattr(jnp, out)), np.float32)
        got = tln.layernorm(xt, _t(g), _t(b), 1e-6, out_dtype=getattr(torch, out))
        assert got.dtype == getattr(torch, out)
        if out == "float32":
            np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-5)
        else:
            assert _bf16_ulps(_f32(got), want) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", [(0, 255), (-128, 127)])
def test_layernorm_quant_int8_plain_matches_jax(dtype, grid):
    """JAX's ``_ln_q_kernel`` (d = 128, interpret mode). The int8 outputs
    may differ by one step where a float32-reassociation difference in the
    statistics moves y across a rounding boundary: at most 1 step, on at
    most 1e-3 of the elements (seen: none of 16,384)."""
    x, g, b = _ln_case(128, 128, seed=5)
    qmin, qmax = grid
    a_s = np.float32(6.0 / 255)
    a_z = np.float32(-127.0) if qmin == 0 else np.float32(0.0)
    xj, xt = jnp.asarray(x), _t(x)
    if dtype == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    qj, zj = jln.layernorm_quant_int8(xj, jnp.asarray(g), jnp.asarray(b), 1e-6, a_s, a_z,
                                      qmin, qmax)
    qt, zt = tln.layernorm_quant_int8(xt, _t(g), _t(b), 1e-6, _t(a_s), _t(a_z), qmin, qmax)
    assert qt.dtype == torch.int8 and float(zt) == float(zj)
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size
    # the plain K7 is K6's float32 result quantized
    y = tln.layernorm(xt, _t(g), _t(b), 1e-6, out_dtype=torch.float32)
    np.testing.assert_array_equal(qt.numpy(), tqm.quantize_act_int8(y, _t(a_s), _t(a_z),
                                                                    qmin, qmax)[0].numpy())


# ---------------------------------------------------------------------------
# K8: mha_fused_qkv_rows
# ---------------------------------------------------------------------------

def _check_attention(got, want, dtype, tol=1e-5):
    """f32: rtol = atol = ``tol`` (summation order of the two products;
    seen below 1e-6 at unit-scale logits); bf16: at most one bf16 ulp
    (seen: equal)."""
    got, want = _f32(got), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        assert _bf16_ulps(got, want) <= 1


@pytest.mark.parametrize("b,s,h,d,valid,causal", [(2, 24, 2, 16, 17, False),
                                                  (2, 24, 2, 64, 17, True),
                                                  (3, 16, 4, 8, 0, True),
                                                  (2, 16, 2, 32, 0, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_matches_jax_kernel(b, s, h, d, valid, causal, dtype):
    qkv = np.random.default_rng(s + d).normal(size=(b * s, 3 * h * d)).astype(np.float32)
    xj, xt = jnp.asarray(qkv).astype(dtype), _t(qkv).to(getattr(torch, dtype))
    want = jattn.mha_fused_qkv_rows(xj, h, s, causal=causal, valid_len=valid, int8_scores=False)
    before = launch_counts()
    got = tattn.mha_fused_qkv_rows(xt, h, s, causal=causal, valid_len=valid)
    assert launch_counts() == before and got.dtype == xt.dtype
    _check_attention(got, want, dtype)


def test_attention_large_positive_logits():
    """``tests/test_attention_kernel.py``'s large-logit case: row maxima
    above 80, pad rows filled with 1e4 and masked by valid_len. Scores of
    magnitude ~100 carry ~1e-5 of summation-order noise into exp, so this
    case holds that test's tolerance, rtol 2e-4 / atol 2e-4 (seen 7.5e-5)."""
    rng = np.random.default_rng(0)
    b, s, h, d, valid = 2, 40, 2, 64, 37
    e = h * d
    padded = np.full((b, s, 3 * e), 1e4, np.float32)
    padded[:, :valid] = (rng.normal(size=(b, valid, 3 * e)) * 6.0).astype(np.float32)
    rows = padded.reshape(b * s, 3 * e)
    scores = np.einsum("bqd,bkd->bqk", padded[:, :valid, :d], padded[:, :valid, e:e + d]) / 8.0
    assert scores.max() > 80
    want = jattn.mha_fused_qkv_rows(jnp.asarray(rows), h, s, valid_len=valid, int8_scores=False)
    got = tattn.mha_fused_qkv_rows(_t(rows), h, s, valid_len=valid)
    _check_attention(got, want, "float32", tol=2e-4)


def test_attention_large_negative_logits():
    """``tests/test_attention_kernel.py``'s all-negative rows (row maxima
    about -100, below the -80 floor): not zeroed, and within that test's
    rtol 2e-4 / atol 2e-4 of JAX's (scores of magnitude ~100)."""
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 32, 2, 64
    e = h * d
    qkv = np.zeros((b, s, 3 * e), np.float32)
    for hh in range(h):
        qkv[..., hh * d:(hh + 1) * d] = rng.normal(size=(b, s, d)) + 3.9
        qkv[..., e + hh * d:e + (hh + 1) * d] = rng.normal(size=(b, s, d)) - 3.9
        qkv[..., 2 * e + hh * d:2 * e + (hh + 1) * d] = rng.normal(size=(b, s, d))
    row_max = (np.einsum("bqd,bkd->bqk", qkv[..., :d], qkv[..., e:e + d]) / 8.0).max(-1)
    assert row_max.max() < -87
    rows = qkv.reshape(b * s, 3 * e)
    want = jattn.mha_fused_qkv_rows(jnp.asarray(rows), h, s, int8_scores=False)
    got = tattn.mha_fused_qkv_rows(_t(rows), h, s)
    assert np.abs(got.numpy()).max() > 0.01
    _check_attention(got, want, "float32", tol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_3d_wrapper_pads_and_matches_jax(causal):
    """(B, S, 3E) with S = 13 padded to 16 inside, pad keys masked."""
    qkv = np.random.default_rng(1).normal(size=(2, 13, 3 * 64)).astype(np.float32)
    want = jattn.mha_fused_qkv(jnp.asarray(qkv), 2, causal=causal)
    got = tattn.mha_fused_qkv(_t(qkv), 2, causal=causal)
    assert tuple(got.shape) == (2, 13, 64)
    _check_attention(got, want, "float32")


def test_attention_pad_query_rows_are_finite_and_causal_pads_are_zero():
    qkv = np.random.default_rng(2).normal(size=(2 * 16, 3 * 32)).astype(np.float32)
    free = tattn.mha_fused_qkv_rows(_t(qkv), 2, 16, valid_len=11).numpy().reshape(2, 16, 32)
    causal = tattn.mha_fused_qkv_rows(_t(qkv), 2, 16, causal=True,
                                      valid_len=11).numpy().reshape(2, 16, 32)
    assert np.isfinite(free).all() and np.isfinite(causal).all()
    np.testing.assert_array_equal(causal[:, 11:], 0.0)


# ---------------------------------------------------------------------------
# QuantDense: the int4 and weight-only packed branches on the same buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("act", ["layer", "channel", "off"])
def test_dense_pack_and_packed_branches_match_jax(w_bits, act):
    """Per-tensor activations take K1 / K4 (bit-equal buffers and logits);
    per-channel or disabled activations take the weight-only product
    (fake-quantized input, dequantized weight, one f32 matmul: XLA and
    oneDNN sum in another order, rtol 1e-5 / atol 1e-5)."""
    from quantize_tpu.nn.layers import LayerQuantCfg as JCfg
    from quantize_tpu.nn.layers import QuantDense as JDense
    from quantize_tpu_torch import convert
    from quantize_tpu_torch.nn.layers import LayerQuantCfg, QuantDense

    w_cfg = {"n_bits": w_bits, "symmetric": True, "granularity": "channel",
             "range": {"name": "minmax"}}
    a_cfg = ({"n_bits": 32} if act == "off" else
             {"n_bits": 8, "symmetric": False, "granularity": act, "range": {"name": "minmax"}})
    x = np.random.default_rng(w_bits).normal(size=(12, 48)).astype(np.float32)
    xj = jnp.asarray(x)
    jmod = JDense(features=20, quant=JCfg(weight=w_cfg, activation=a_cfg))
    tmod = QuantDense(48, 20, quant=LayerQuantCfg(weight=w_cfg, activation=a_cfg), device="cpu")
    v = dict(jmod.init(jax.random.PRNGKey(0), xj, mode="calibrate"))
    v.pop("taps", None)
    convert.from_jax_variables(tmod, jax.device_get(v))
    _, upd = jmod.apply(v, xj, mode="pack", mutable=["packed"])
    with torch.no_grad():
        tmod(_t(x), mode="pack")
    mine = convert.flatten(convert.to_numpy(tmod)["packed"])
    theirs = convert.flatten(jax.device_get(upd["packed"]))
    assert set(mine) == set(theirs) and ("w_p4" in mine) == (w_bits == 4)
    for key, val in theirs.items():
        np.testing.assert_array_equal(mine[key], np.asarray(val), err_msg=key)
    want = np.asarray(jmod.apply({**v, **upd}, xj, mode="packed"))
    with torch.no_grad():
        got = tmod(_t(x), mode="packed").numpy()
    if act == "layer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
