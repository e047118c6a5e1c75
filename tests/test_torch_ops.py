"""Parity of the port's packed int8 ops (the plain PyTorch versions of
kernels K1, K2, K3, which their wrappers run on CPU tensors) with the JAX
package's functions.

Tolerances: the integer accumulators must be bit-equal. Float outputs are
held to rtol 1e-5 / atol 1e-4 -- the tolerance of tests/test_qconv1x1.py
for the same epilogues -- although the port mirrors the JAX expression
order and is bit-equal in practice; bf16 outputs are compared after both
round the same float32 value, so they are held to the same bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.nn.layers import LayerQuantCfg as JCfg
from quantize_tpu.nn.layers import QuantConv as JConv
from quantize_tpu.nn.layers import QuantDense as JDense
from quantize_tpu.ops.pallas.qconv1x1 import conv1x1_residual as jax_conv1x1_residual
from quantize_tpu.ops.pallas.qmatmul import matmul_backend, set_matmul_backend
from quantize_tpu.ops.pallas.qmatmul import quant_matmul_w8a8 as jax_quant_matmul_w8a8
from quantize_tpu.ops.qconv import quant_conv2d as jax_quant_conv2d
from quantize_tpu.ops.qconv import conv_zero_correction_map as jax_corr_map
from quantize_tpu_torch import convert
from quantize_tpu_torch.nn.layers import LayerQuantCfg, QuantConv, QuantDense
from quantize_tpu_torch.ops import launch_counts, ref
from quantize_tpu_torch.ops.qconv import (conv_zero_correction_map, int8_conv_exact,
                                          kmajor_weight, quant_conv2d, resolve_padding,
                                          s2d_block_padding, s2d_kernel, space_to_depth)
from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual
from quantize_tpu_torch.ops.qmatmul import (int8_matmul_exact, quant_matmul_w8a8,
                                            quantize_act_int8)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# K1: quant_matmul_w8a8
# ---------------------------------------------------------------------------

def _mm_case(m, k, n, sym_w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    a_scale = np.float32(np.abs(x).max() / 255.0)
    a_zero = np.float32(x.min() / a_scale)
    w_int = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    w_scale = rng.uniform(0.005, 0.02, size=(n,)).astype(np.float32)
    w_zero = (np.zeros((n,), np.float32) if sym_w
              else rng.uniform(-3, 3, size=(n,)).astype(np.float32))
    bias = rng.normal(size=(n,)).astype(np.float32)
    return x, a_scale, a_zero, w_int, w_scale, w_zero, bias


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("shape", [(32, 64, 48), (100, 130, 70), (8, 2048, 40)])
@pytest.mark.parametrize("sym_w", [True, False])
def test_w8a8_plain_matches_jax(backend, shape, sym_w):
    x, a_s, a_z, w, w_s, w_z, b = _mm_case(*shape, sym_w=sym_w, seed=sum(shape))
    prev = matmul_backend()
    set_matmul_backend(backend)  # "pallas" runs _w8a8_kernel in interpret mode
    try:
        want = np.asarray(jax_quant_matmul_w8a8(
            jnp.asarray(x), a_s, a_z, 0, 255, jnp.asarray(w), jnp.asarray(w_s),
            jnp.asarray(w_z), jnp.asarray(b), w_zero_is_zero=sym_w))
    finally:
        set_matmul_backend(prev)
    got = quant_matmul_w8a8(_t(x), _t(a_s), _t(a_z), 0, 255, _t(w), _t(w_s), _t(w_z), _t(b),
                            w_zero_is_zero=sym_w)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_int8_matmul_accumulator_is_exact():
    rng = np.random.default_rng(5)
    q = rng.integers(-128, 128, size=(64, 4096)).astype(np.int8)
    w = rng.integers(-128, 128, size=(4096, 24)).astype(np.int8)
    want = np.asarray(jax.lax.dot_general(jnp.asarray(q), jnp.asarray(w), (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    got = int8_matmul_exact(_t(q), _t(w)).long().numpy()
    np.testing.assert_array_equal(got, want)


def test_w8a8_plain_matches_oracle():
    x, a_s, a_z, w, w_s, w_z, b = _mm_case(40, 96, 30, sym_w=False, seed=9)
    args = (_t(x), _t(a_s), _t(a_z), 0, 255, _t(w), _t(w_s), _t(w_z), _t(b))
    got = quant_matmul_w8a8(*args)
    np.testing.assert_allclose(got.numpy(), ref.quant_matmul_int_ref(*args).numpy(), rtol=RTOL, atol=ATOL)
    # dequantize-then-matmul oracle: float32 sums in another order
    np.testing.assert_allclose(got.numpy(), ref.quant_matmul_ref(*args).numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K2: conv1x1_residual
# ---------------------------------------------------------------------------

K2_SHAPES = [((2, 8, 8), 64, 256), ((1, 7, 7), 512, 128), ((3, 5, 6), 48, 96)]


@pytest.mark.parametrize("shape,k,co", K2_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("res_dtype", ["float32", "bfloat16"])
def test_conv1x1_residual_plain_matches_jax(shape, k, co, relu, res_dtype):
    _check_conv1x1_residual(shape, k, co, relu, res_dtype, with_kmajor=False)


@pytest.mark.parametrize("shape,k,co", K2_SHAPES + [((2, 3, 5), 24, 40)])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("res_dtype", ["float32", "bfloat16"])
def test_conv1x1_residual_with_the_kmajor_copy_matches_jax(shape, k, co, relu, res_dtype):
    """The K-major copy (what K2's wgmma route reads; K = 24 carries zero
    columns past K) beside the weight gives JAX's output."""
    _check_conv1x1_residual(shape, k, co, relu, res_dtype, with_kmajor=True)


def _check_conv1x1_residual(shape, k, co, relu, res_dtype, with_kmajor):
    rng = np.random.default_rng(0)
    n, h, w_sp = shape
    q_a = rng.integers(-128, 128, size=(n, h, w_sp, k)).astype(np.int8)
    w_int = rng.integers(-127, 128, size=(1, 1, k, co)).astype(np.int8)
    w_scale = rng.uniform(0.001, 0.02, size=(co,)).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    res = rng.normal(size=(n, h, w_sp, co)).astype(np.float32)
    a_scale, z_eff = np.float32(0.013), np.float32(127.4)
    res_j, res_t = jnp.asarray(res), _t(res)
    if res_dtype == "bfloat16":
        res_j, res_t = res_j.astype(jnp.bfloat16), res_t.to(torch.bfloat16)
    want = jax_conv1x1_residual(jnp.asarray(q_a), z_eff, a_scale, jnp.asarray(w_int),
                                jnp.asarray(w_scale), jnp.asarray(bias), res_j, relu=relu)
    w_km = kmajor_weight(_t(w_int)) if with_kmajor else None
    got = conv1x1_residual(_t(q_a), _t(z_eff), _t(a_scale), _t(w_int), _t(w_scale), _t(bias),
                           res_t, relu=relu, w_km=w_km)
    assert got.dtype == res_t.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# K3: quant_conv2d
# ---------------------------------------------------------------------------

def _conv_case(hw, ci, co, k, sym_w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, hw, hw, ci)).astype(np.float32)
    a_scale = np.float32((x.max() - x.min()) / 255.0)
    a_zero = np.float32(x.min() / a_scale)
    w_int = rng.integers(-128, 128, size=(k, k, ci, co)).astype(np.int8)
    w_scale = rng.uniform(0.001, 0.02, size=(co,)).astype(np.float32)
    w_zero = (np.zeros((co,), np.float32) if sym_w
              else rng.uniform(-3, 3, size=(co,)).astype(np.float32))
    bias = rng.normal(size=(co,)).astype(np.float32)
    return x, a_scale, a_zero, w_int, w_scale, w_zero, bias


@pytest.mark.parametrize("strides,padding", [((1, 1), [(1, 1), (1, 1)]), ((2, 2), [(1, 1), (1, 1)]),
                                             ((1, 1), "SAME"), ((2, 2), "SAME")])
@pytest.mark.parametrize("sym_w", [True, False])
@pytest.mark.parametrize("with_corr", [True, False])
def test_quant_conv2d_plain_matches_jax(strides, padding, sym_w, with_corr):
    hw = 13 if strides == (2, 2) else 10  # odd size: SAME pads asymmetrically
    x, a_s, a_z, w, w_s, w_z, b = _conv_case(hw, 8, 12, 3, sym_w, seed=hw)
    corr_j = jax_corr_map(jnp.asarray(w), hw, hw, strides, padding) if with_corr else None
    want = jax_quant_conv2d(jnp.asarray(x), a_s, a_z, 0, 255, jnp.asarray(w), jnp.asarray(w_s),
                            jnp.asarray(w_z), jnp.asarray(b), strides=strides, padding=padding,
                            w_zero_is_zero=sym_w, corr_a=corr_j)
    corr_t = conv_zero_correction_map(_t(w), hw, hw, strides, padding) if with_corr else None
    if with_corr:
        np.testing.assert_array_equal(corr_t.numpy(), np.asarray(corr_j))
    got = quant_conv2d(_t(x), _t(a_s), _t(a_z), 0, 255, _t(w), _t(w_s), _t(w_z), _t(b),
                       strides=strides, padding=padding, w_zero_is_zero=sym_w, corr_a=corr_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    oracle = ref.quant_conv2d_ref(_t(x), _t(a_s), _t(a_z), 0, 255, _t(w), _t(w_s), _t(w_z),
                                  _t(b), strides, padding)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-4, atol=1e-4)


def test_quant_conv2d_bf16_out_and_int_accumulator():
    x, a_s, a_z, w, w_s, w_z, b = _conv_case(9, 16, 8, 3, True, seed=3)
    want = jax_quant_conv2d(jnp.asarray(x), a_s, a_z, 0, 255, jnp.asarray(w), jnp.asarray(w_s),
                            jnp.asarray(w_z), jnp.asarray(b), padding=[(1, 1), (1, 1)],
                            w_zero_is_zero=True, out_dtype=jnp.bfloat16)
    got = quant_conv2d(_t(x), _t(a_s), _t(a_z), 0, 255, _t(w), _t(w_s), _t(w_z), _t(b),
                       padding=[(1, 1), (1, 1)], w_zero_is_zero=True, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)
    q, _ = quantize_act_int8(_t(x), _t(a_s), _t(a_z), 0, 255)
    acc_j = jax.lax.conv_general_dilated(jnp.asarray(q.numpy()), jnp.asarray(w), (2, 2),
                                         [(1, 0), (0, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                         preferred_element_type=jnp.int32)
    acc_t = int8_conv_exact(q, _t(w), (2, 2), ((1, 0), (0, 1))).long().numpy()
    np.testing.assert_array_equal(acc_t, np.asarray(acc_j))


@pytest.mark.parametrize("hw", [32, 224])
def test_s2d_stem_matches_direct_conv_and_jax(hw):
    # the packed ResNet stem: 7x7/s2 pad 3 over 3 channels, rewritten as a
    # 4x4/s1 conv over the 2x2 space-to-depth input (12 channels)
    x, a_s, a_z, w, w_s, w_z, b = _conv_case(hw, 3, 16, 7, True, seed=11)
    pad = [(3, 3), (3, 3)]
    corr = conv_zero_correction_map(_t(w), hw, hw, (2, 2), pad)
    direct = quant_conv2d(_t(x), _t(a_s), _t(a_z), 0, 255, _t(w), _t(w_s), _t(w_z), _t(b),
                          strides=(2, 2), padding=pad, w_zero_is_zero=True, corr_a=corr)
    q, z_eff = quantize_act_int8(_t(x), _t(a_s), _t(a_z), 0, 255)
    bp = s2d_block_padding(7, 7, pad, hw, hw)
    assert bp == [(2, 1), (2, 1)]
    q_s2d = space_to_depth(q)
    got = quant_conv2d(q_s2d, _t(a_s), _t(a_z), 0, 255, s2d_kernel(_t(w)), _t(w_s), _t(w_z),
                       _t(b), strides=(1, 1), padding=bp, w_zero_is_zero=True, corr_a=corr,
                       pre_q=(q_s2d, z_eff))
    np.testing.assert_array_equal(got.numpy(), direct.numpy())  # same integer sums
    want = jax_quant_conv2d(jnp.asarray(x), a_s, a_z, 0, 255, jnp.asarray(w), jnp.asarray(w_s),
                            jnp.asarray(w_z), jnp.asarray(b), strides=(2, 2), padding=pad,
                            w_zero_is_zero=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_resolve_padding_same_matches_jax_semantics():
    # JAX puts the odd padding pixel at the end
    assert resolve_padding("SAME", 3, 3, 13, 12, (2, 2)) == ((1, 1), (0, 1))
    assert resolve_padding("VALID", 3, 3, 13, 12, (2, 2)) == ((0, 0), (0, 0))


def test_grouped_conv_raises():
    """A grouped conv runs (kernel K3g; its plain version on the CPU),
    bit-equal to JAX's; input channels that do not split into the groups
    of the kernel's input width raise ValueError before any kernel."""
    x, a_s, a_z, w, w_s, w_z, b = _conv_case(6, 8, 8, 3, True, seed=1)
    got = quant_conv2d(_t(x), _t(a_s), _t(a_z), 0, 255, _t(w[:, :, :4]), _t(w_s), _t(w_z), _t(b),
                       groups=2)
    want = jax_quant_conv2d(jnp.asarray(x), a_s, a_z, 0, 255, jnp.asarray(w[:, :, :4]),
                            jnp.asarray(w_s), jnp.asarray(w_z), jnp.asarray(b), groups=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="groups"):
        quant_conv2d(_t(x), _t(a_s), _t(a_z), 0, 255, _t(w[:, :, :3]), _t(w_s), _t(w_z), _t(b),
                     groups=2)


# ---------------------------------------------------------------------------
# Layers: packed vs JAX on the same deploy buffers, incl. asymmetric weights
# (the z_w != 0 kernel paths that ResNet's symmetric weights never reach)
# ---------------------------------------------------------------------------

def _layer_cfg(sym_w):
    w = {"n_bits": 8, "symmetric": sym_w, "granularity": "channel", "range": {"name": "minmax"}}
    a = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}
    return w, a


@pytest.mark.parametrize("kind", ["dense", "conv3x3s2", "conv1x1"])
@pytest.mark.parametrize("sym_w", [True, False])
def test_layer_pack_and_packed_match_jax(kind, sym_w):
    w_cfg, a_cfg = _layer_cfg(sym_w)
    rng = np.random.default_rng(4)
    if kind == "dense":
        x = rng.normal(size=(16, 64)).astype(np.float32)
        jmod = JDense(features=32, quant=JCfg(weight=w_cfg, activation=a_cfg))
        tmod = QuantDense(64, 32, quant=LayerQuantCfg(weight=w_cfg, activation=a_cfg), device="cpu")
    else:
        k, s = (3, 2) if kind == "conv3x3s2" else (1, 1)
        pad = [(k // 2, k // 2)] * 2
        x = rng.normal(size=(2, 12, 12, 16)).astype(np.float32)
        jmod = JConv(features=24, kernel_size=(k, k), strides=(s, s), padding=pad,
                     quant=JCfg(weight=w_cfg, activation=a_cfg, bn_folding=True))
        tmod = QuantConv(16, 24, (k, k), (s, s), pad,
                         quant=LayerQuantCfg(weight=w_cfg, activation=a_cfg, bn_folding=True),
                         device="cpu")
    xj = jnp.asarray(x)
    v = dict(jmod.init(jax.random.PRNGKey(0), xj, mode="calibrate"))
    v.pop("taps", None)
    convert.from_jax_variables(tmod, jax.device_get(v))
    _, upd = jmod.apply(v, xj, mode="pack", mutable=["packed"])
    with torch.no_grad():
        tmod(_t(x), mode="pack")
    mine = convert.flatten(convert.to_numpy(tmod)["packed"])
    theirs = convert.flatten(jax.device_get(upd["packed"]))
    assert set(mine) == set(theirs)
    for key, val in theirs.items():
        np.testing.assert_array_equal(mine[key], np.asarray(val), err_msg=key)
    want = np.asarray(jmod.apply({**v, **upd}, xj, mode="packed"))
    before = launch_counts()
    with torch.no_grad():
        got = tmod(_t(x), mode="packed").numpy()
    assert launch_counts() == before  # CPU tensors take the plain versions
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["relu", "maxpool", "avgpool"])
@pytest.mark.parametrize("granularity", ["layer", "channel"])
def test_activation_quant_layers_match_jax(kind, granularity):
    from quantize_tpu.nn.layers import QuantGlobalAvgPool as JAvg
    from quantize_tpu.nn.layers import QuantMaxPool as JMax
    from quantize_tpu.nn.layers import QuantReLU as JRelu
    from quantize_tpu_torch.nn.layers import QuantGlobalAvgPool, QuantMaxPool, QuantReLU

    act = {"n_bits": 8, "symmetric": False, "granularity": granularity,
           "range": {"name": "minmax"}}
    jcfg, tcfg = JCfg(activation=act), LayerQuantCfg(activation=act)
    pool = dict(window=(3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])
    jmod, tmod = {
        "relu": (JRelu(quant=jcfg), QuantReLU(tcfg, 6, "cpu")),
        "maxpool": (JMax(quant=jcfg, **pool), QuantMaxPool(quant=tcfg, in_ch=6, device="cpu", **pool)),
        "avgpool": (JAvg(quant=jcfg), QuantGlobalAvgPool(tcfg, 6, "cpu")),
    }[kind]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 9, 6)).astype(np.float32)
    xj = jnp.asarray(x)
    v = dict(jmod.init(jax.random.PRNGKey(0), xj, mode="calibrate"))
    v.pop("taps", None)
    convert.from_jax_variables(tmod, {"qparams": jax.device_get(v["qparams"])})
    _, upd = jmod.apply(v, xj, mode="calibrate", mutable=["qobs", "qparams"])
    with torch.no_grad():
        tmod(_t(x), mode="calibrate")
        for col in ("qparams",):
            mine = convert.flatten(convert.to_numpy(tmod)[col])
            for key, val in convert.flatten(jax.device_get(upd[col])).items():
                np.testing.assert_array_equal(mine[key], val, err_msg=key)
        for mode in ("fp32", "quant", "packed"):
            want = np.asarray(jmod.apply({**v, **upd}, xj, mode=mode))
            got = tmod(_t(x), mode=mode).numpy()
            # relu and max pool are exact; the mean sums 81 values in
            # another order (float32 reassociation, ~1e-7 relative)
            np.testing.assert_allclose(got, want, rtol=RTOL if kind == "avgpool" else 0,
                                       atol=1e-7 if kind == "avgpool" else 0, err_msg=mode)
