"""The grouped int8 conv (kernel K3g's plain version), the grouped and
depthwise packed ``QuantConv`` and ResNeXt, held against the JAX package on
the CPU.

* ``qconv2d_grouped_int8_plain`` against JAX's ``quant_conv2d`` with
  ``groups`` at the shapes of ``chip_smoke.py``'s K3g phase (small batch):
  the integer sums bit for bit (JAX's int8 conv with ``feature_group_count``
  and int32 sums), the epilogue bit-equal to eager JAX (the same float32
  operations in the same order).
* A grouped and a depthwise ``QuantConv`` calibrate (rtol 1e-5, float32
  reassociation of the calibrate conv), pack (integer buffers and the
  correction map bit-equal) and serve as JAX does. The grouped conv's
  packed output, from its own pack and from JAX's deploy variables loaded
  through ``convert``, is bit-equal to eager JAX at f32 carry and within
  one float32 rounding per epilogue operation of jitted JAX (XLA contracts
  the epilogue into FMAs). The depthwise conv takes the float path (no
  kernel): a float32 conv, summed in another order than XLA's, rtol 1e-5.
* ResNeXt-50 32x4d W8A8 (batch 2, 32 x 32, 10 classes): calibrated
  qparams rtol 1e-5, pack buffers bit-equal, and the packed logits
  bit-equal to JAX's with the fused residual tail, from its own pack and
  from JAX's deploy variables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.nn.layers import LayerQuantCfg as JaxLayerQuantCfg
from quantize_tpu.nn.layers import QuantConv as JaxQuantConv
from quantize_tpu.nn.precision import fused_residual as jax_fused_residual
from quantize_tpu.ops.qconv import quant_conv2d as jax_quant_conv2d
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.nn.layers import LayerQuantCfg, QuantConv
from quantize_tpu_torch.ops import launch_counts
from quantize_tpu_torch.ops.qconv import conv_nhwc, quant_conv2d, resolve_padding

torch.set_num_threads(2)

W8 = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
      "range": {"name": "minmax"}}
W8_ASYM = {"n_bits": 8, "symmetric": False, "granularity": "channel",
           "range": {"name": "minmax"}}
A8 = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}

# (N, H, W, Ci, Co, G, k, stride, z_w == 0, out dtype): chip_smoke.py's
# GROUPED_SHAPES at a small batch and size (both K3g routes' shapes)
SHAPES = (
    (2, 8, 8, 8, 12, 2, 3, 1, True, "float32"),
    (1, 8, 8, 128, 128, 32, 3, 1, True, "float32"),
    (1, 8, 8, 256, 256, 32, 3, 2, True, "bfloat16"),
    (1, 5, 5, 2048, 2048, 32, 3, 1, True, "float32"),
    (1, 6, 6, 256, 256, 64, 3, 1, True, "float32"),
    (2, 9, 9, 24, 24, 24, 3, 1, False, "float32"),
    (2, 9, 9, 48, 48, 24, 3, 2, False, "float32"),
    (2, 9, 9, 36, 72, 12, 3, 1, False, "bfloat16"),
    (2, 8, 8, 64, 64, 4, 3, 1, False, "float32"),
    (1, 10, 10, 8, 260, 2, 3, 2, False, "float32"),
    (1, 11, 11, 20, 30, 5, 5, 2, False, "float32"),
    (1, 8, 8, 128, 128, 32, 3, 2, False, "bfloat16"),
    (2, 7, 7, 256, 256, 32, 1, 1, False, "float32"),
    (1, 6, 6, 64, 64, 2, 3, 1, False, "float32"),
    (1, 6, 6, 128, 128, 2, 3, 1, False, "float32"),
    (1, 6, 6, 96, 96, 12, 3, 1, True, "float32"),
    (1, 9, 9, 64, 64, 16, 5, 2, False, "float32"),
)


def _operands(shape, seed):
    n, h, w, ci, co, g, k, s, wz0, dt = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h, w, ci)) * 2).astype(np.float32)
    w_int = rng.integers(-127, 128, size=(k, k, ci // g, co)).astype(np.int8)
    w_scale = (rng.random(co) * 0.01).astype(np.float32)
    w_zero = np.zeros(co, np.float32) if wz0 else rng.normal(size=co).astype(np.float32)
    bias = rng.normal(size=co).astype(np.float32)
    return x, w_int, w_scale, w_zero, bias


@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_sums_and_epilogue_match_jax(shape):
    n, h, w, ci, co, g, k, s, wz0, dt = shape
    x, w_int, w_scale, w_zero, bias = _operands(shape, sum(shape[:8]))
    a_scale, a_zero = np.float32(0.03), np.float32(-5.0)
    # the integer sums: JAX's int8 grouped conv with int32 sums, the port's
    # exact float64 sums
    q = np.random.default_rng(1).integers(-128, 128, size=x.shape).astype(np.int8)
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(q), jnp.asarray(w_int), (s, s), "SAME", feature_group_count=g,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    pads = resolve_padding("SAME", k, k, h, w, (s, s))
    acc_t = conv_nhwc(torch.from_numpy(q).double(), torch.from_numpy(w_int).double(), (s, s),
                      pads, g).numpy()
    np.testing.assert_array_equal(acc_t.astype(np.int64), acc_j.astype(np.int64))
    # the whole conv, activation quantize and epilogue included
    out_dtype = getattr(jnp, dt)
    want = np.asarray(jax_quant_conv2d(
        jnp.asarray(x), jnp.asarray(a_scale), jnp.asarray(a_zero), 0, 255, jnp.asarray(w_int),
        jnp.asarray(w_scale), jnp.asarray(w_zero), jnp.asarray(bias), strides=(s, s),
        padding="SAME", groups=g, w_zero_is_zero=wz0, out_dtype=out_dtype).astype(jnp.float32))
    got = quant_conv2d(torch.from_numpy(x), torch.tensor(a_scale), torch.tensor(a_zero), 0, 255,
                       torch.from_numpy(w_int), torch.from_numpy(w_scale),
                       torch.from_numpy(w_zero), torch.from_numpy(bias), strides=(s, s),
                       padding="SAME", groups=g, w_zero_is_zero=wz0,
                       out_dtype=getattr(torch, dt)).float().numpy()
    np.testing.assert_array_equal(got, want)


def _jax_layer(features, k, s, groups, quant):
    return JaxQuantConv(features, (k, k), strides=(s, s), padding=[(k // 2, k // 2)] * 2,
                        feature_group_count=groups, quant=JaxLayerQuantCfg(**quant))


# (in channels, out channels, groups, kernel, stride, weight setting): a
# ResNeXt-style grouped conv with symmetric and with asymmetric weights (the
# row-sum term), and a depthwise conv
LAYERS = {"grouped": (32, 48, 8, 3, 1, W8), "grouped_asym": (24, 24, 6, 3, 2, W8_ASYM),
          "depthwise": (16, 16, 16, 3, 1, W8)}


@pytest.fixture(scope="module", params=sorted(LAYERS))
def layer(request):
    ci, co, g, k, s, wq = LAYERS[request.param]
    quant = dict(weight=wq, activation=A8)
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 9, 9, ci)) + 0.2).astype(np.float32)
    x_cal = (rng.normal(size=(2, 9, 9, ci)) + 0.2).astype(np.float32)
    jm = _jax_layer(co, k, s, g, quant)
    v0 = dict(jm.init(jax.random.PRNGKey(3), jnp.asarray(x), mode="calibrate"))
    v0.pop("taps", None)
    _, upd = jm.apply(v0, jnp.asarray(x_cal), mode="calibrate", mutable=["qobs", "qparams"])
    v1 = jax.device_get({**v0, **upd})
    deploy = jax.device_get(jax_pack_model(jm, v1, jnp.asarray(x)))
    tm = QuantConv(ci, co, (k, k), (s, s), padding=[(k // 2, k // 2)] * 2, feature_group_count=g,
                   quant=LayerQuantCfg(**quant), device="cpu")
    convert.from_jax_variables(tm, jax.device_get(v0))
    with torch.no_grad():
        tm(torch.from_numpy(x_cal), mode="calibrate")
    out = {"name": request.param, "calibrated": (convert.to_numpy(tm), v1)}
    convert.from_jax_variables(tm, v1)
    with torch.no_grad():
        tm(torch.from_numpy(x), mode="pack")
    out["packed"] = (convert.flatten(convert.to_numpy(tm)["packed"]),
                     convert.flatten(deploy["packed"]))
    fresh = QuantConv(ci, co, (k, k), (s, s), padding=[(k // 2, k // 2)] * 2,
                      feature_group_count=g, quant=LayerQuantCfg(**quant), device="cpu")
    convert.from_jax_variables(fresh, deploy)
    before = launch_counts()
    with torch.no_grad():
        out["port"] = [m(torch.from_numpy(x), mode="packed").numpy() for m in (tm, fresh)]
    out["launches_unchanged"] = launch_counts() == before
    out["eager"] = np.asarray(jm.apply(deploy, jnp.asarray(x), mode="packed"))
    out["jit"] = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, mode="packed"))(
        deploy, jnp.asarray(x)))
    out["buffers"] = {"w_grouped": hasattr(fresh, "w_grouped"),
                      "w_kmajor": hasattr(fresh, "w_kmajor")}
    return out


def test_layer_calibrates_as_jax(layer):
    port, theirs = layer["calibrated"]
    for col in ("qparams", "qobs"):
        m, t = convert.flatten(port[col]), convert.flatten(theirs[col])
        assert set(m) == set(t), col
        for key, val in t.items():
            np.testing.assert_allclose(m[key], val, rtol=1e-5, atol=1e-7, err_msg=key)


def test_layer_packs_as_jax(layer):
    mine, theirs = layer["packed"]
    assert set(mine) == set(theirs) and "corr_a" in theirs and "w_int" in theirs
    for key, val in theirs.items():
        assert mine[key].dtype == np.asarray(val).dtype, key
        if key in ("w_int", "corr_a"):
            np.testing.assert_array_equal(mine[key], val, err_msg=key)
        else:
            np.testing.assert_allclose(mine[key], val, rtol=1e-6, atol=0, err_msg=key)
    # the grouped kernel's own weight copy, made at load, and never K3's
    assert layer["buffers"] == {"w_grouped": True, "w_kmajor": False}


def test_layer_serves_as_jax(layer):
    eager, jit = layer["eager"], layer["jit"]
    assert layer["launches_unchanged"]  # CPU tensors: the plain versions, no launch
    for got in layer["port"]:
        if layer["name"] == "depthwise":
            # the float path: a float32 conv summed in another order than XLA's
            np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-6 * np.abs(eager).max())
            continue
        np.testing.assert_array_equal(got, eager)
        # jitted XLA fuses the epilogue (FMAs): a few float32 roundings of the
        # largest output at most; seen: 0 or 1 ulp
        assert np.abs(got - jit).max() <= 4 * np.spacing(np.float32(np.abs(jit).max()))


def test_resnext_packed_matches_jax():
    """ResNeXt-50 32x4d W8A8 end to end: K3g's plain version at every
    bottleneck's conv2, with K3, K2 (the fused tail) and K1."""
    cfg = {"default": {"weight": W8, "activation": A8, "bn_folding": True}}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JAX_MODELS.build("resnext50_32x4d", num_classes=10, ctx=JaxQuantCtx(cfg))
    v0 = dict(jax.jit(lambda k, a: jm.init(k, a, mode="calibrate"))(jax.random.PRNGKey(0),
                                                                      jnp.asarray(x)))
    v0.pop("taps", None)
    v0 = jax.device_get(v0)
    _, upd = jax.jit(lambda v, a: jm.apply(v, a, mode="calibrate", mutable=["qobs", "qparams"]))(
        v0, jnp.asarray(x_cal))
    v1 = jax.device_get({**v0, **upd})
    tm = qtt.MODELS.build("resnext50_32x4d", num_classes=10, ctx=qtt.QuantCtx(cfg), device="cpu")
    convert.from_jax_variables(tm, v0)
    qtt.calibrate_model(tm, [x_cal], device="cpu")
    m, t = convert.flatten(convert.to_numpy(tm)["qparams"]), convert.flatten(v1["qparams"])
    assert set(m) == set(t)
    for key, val in t.items():
        np.testing.assert_allclose(m[key], val, rtol=1e-5, atol=1e-7, err_msg=key)
    convert.from_jax_variables(tm, v1)
    deploy = jax.device_get(jax_pack_model(jm, v1, jnp.asarray(x)))
    qtt.pack_model(tm, x, device="cpu")
    m, t = convert.flatten(convert.to_numpy(tm)["packed"]), convert.flatten(deploy["packed"])
    assert set(m) == set(t)
    for key, val in t.items():
        if key.endswith(("w_int", "corr_a", "col_sum")):
            np.testing.assert_array_equal(m[key], val, err_msg=key)
    fresh = qtt.MODELS.build("resnext50_32x4d", num_classes=10, ctx=qtt.QuantCtx(cfg),
                             device="cpu")
    convert.from_jax_variables(fresh, deploy)
    with jax_fused_residual(True):
        want = np.asarray(jm.apply(deploy, jnp.asarray(x), mode="packed"))
    with qtt.fused_residual(True), torch.no_grad():
        for model in (tm, fresh):
            np.testing.assert_array_equal(model(torch.from_numpy(x), mode="packed").numpy(), want)
