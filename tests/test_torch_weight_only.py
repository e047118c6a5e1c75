"""The weight-only path (float activations, int8/int4 weights) of the port
against the JAX package on the CPU: kernel K5's plain version, the
weight-only conv, a tiny ViT served weight-only W4 and a tiny ResNet-18
weight-only W8.

The quant config is the weight-only section of
``configs/runners/ptq/weight_quantize/mse_channel.yaml``: symmetric signed
per-channel weights with the MSE range search (maxshrink 0.8, grid 100),
activations at 32 bits, folded BN.

* K5 (``wo_gemm_plain``) vs the Pallas ``_wo_call`` in interpret mode, f32
  and bf16 compute: both form the same float32 products (exact for bf16
  operands) and sum them in float32 in another order, so the difference is
  held to 2^-20 of sum|a*w| per output (seen 1.5e-7 of it, 2^-22.7).
* ``quant_conv2d_wo``: float32 convolutions summed in another order,
  rtol 1e-5 / atol 1e-5.
* Whole models on the same deploy buffers at f32 carry: float32 products in
  another order through every layer, criterion 1e-4 of max|JAX logits|
  (seen: ViT 2.7e-7 at hidden 32 and 8.8e-7 at 128, ResNet-18 7.8e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.models.vit import VisionTransformer as JViT
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.nn.precision import fused_residual as jax_fused_residual
from quantize_tpu.ops import qconv as jqconv
from quantize_tpu.ops.pallas import qmatmul as jqm
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.models.vit import VisionTransformer
from quantize_tpu_torch.ops import launch_counts
from quantize_tpu_torch.ops import qconv as tqconv
from quantize_tpu_torch.ops import qmatmul as tqm

torch.set_num_threads(2)


def _weight(bits):
    return {"n_bits": bits, "symmetric": True, "signed": True, "granularity": "channel",
            "range": {"name": "mse", "maxshrink": 0.8, "grid": 100}}


def _cfg(bits):
    return {"default": {"weight": _weight(bits), "activation": {"n_bits": 32},
                        "bn_folding": True}}


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / np.max(np.abs(b)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# K5: wo_gemm_plain vs the Pallas _wo_call
# ---------------------------------------------------------------------------

def _wo_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.integers(-8, 8, size=(k, n)).astype(np.int8)
    w_s = rng.uniform(0.001, 0.05, size=(n,)).astype(np.float32)
    w_z = rng.uniform(-2, 2, size=(n,)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, w, w_s, w_z, b


@pytest.fixture
def pallas_backend():
    prev = jqm.matmul_backend()
    jqm.set_matmul_backend("pallas")
    yield
    jqm.set_matmul_backend(prev)


@pytest.mark.parametrize("m,k,n", [(37, 700, 1000), (300, 1030, 70), (5, 48, 24),
                                   (127, 40, 1000), (1, 3072, 8)])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_wo_gemm_plain_matches_the_pallas_kernel(pallas_backend, m, k, n, compute):
    """Ragged M, N and K (K = 700 and 1030 are not multiples of the Pallas
    block of 512; N = 1000 is the head's; 127 x 40 x 1000 and 1 x 3072 x 8
    are ragged at every edge of the CUDA kernel's 128 x 128 x 64 tile). f32 compute goes through JAX's
    ``quant_matmul_wo`` on the Pallas backend (which feeds ``_wo_call``
    float32); bf16 compute feeds ``_wo_call`` a bf16 x, which runs
    ``_wo_kernel``'s bf16 body."""
    x, w, w_s, w_z, b = _wo_case(m, k, n, seed=m + k)
    if compute == "float32":
        want = jqm.quant_matmul_wo(jnp.asarray(x), jnp.asarray(w), jnp.asarray(w_s),
                                   jnp.asarray(w_z), jnp.asarray(b))
        xa = x
    else:
        want = jqm._wo_call(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(w_s),
                            jnp.asarray(w_z), jnp.asarray(b))
        xa = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(want)
    before = launch_counts()
    got = tqm.wo_gemm_plain(_t(x), _t(w), _t(w_s), _t(w_z), _t(b), getattr(torch, compute))
    assert launch_counts() == before and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (m, n)
    w_deq = np.asarray(jqm._dequant_weight(jnp.asarray(w), jnp.asarray(w_s), jnp.asarray(w_z)))
    if compute == "bfloat16":
        w_deq = np.asarray(jnp.asarray(w_deq, jnp.bfloat16).astype(jnp.float32))
    bound = np.abs(xa).astype(np.float64) @ np.abs(w_deq).astype(np.float64)
    assert np.all(np.abs(got.numpy().astype(np.float64) - want) <= 2.0 ** -20 * bound + 1e-30)
    # the same through the port's wrapper on a CPU tensor (f32 compute)
    if compute == "float32":
        np.testing.assert_array_equal(
            tqm.wo_gemm(_t(x), _t(w), _t(w_s), _t(w_z), _t(b), torch.float32).numpy(),
            got.numpy())


def test_quant_matmul_wo_goes_through_wo_gemm(monkeypatch):
    """The weight-only matmul calls K5's wrapper with f32 compute on the
    CPU; the leading dims fold into M."""
    seen = []
    orig = tqm.wo_gemm

    def spy(x, w_int, w_scale, w_zero, bias, compute_dtype):
        seen.append((tuple(x.shape), compute_dtype))
        return orig(x, w_int, w_scale, w_zero, bias, compute_dtype)

    monkeypatch.setattr(tqm, "wo_gemm", spy)
    x, w, w_s, w_z, b = _wo_case(6, 16, 8, seed=1)
    out = tqm.quant_matmul_wo(_t(x).reshape(2, 3, 16), _t(w), _t(w_s), _t(w_z), _t(b))
    assert tuple(out.shape) == (2, 3, 8) and seen == [((6, 16), torch.float32)]


# ---------------------------------------------------------------------------
# quant_conv2d_wo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,strides,padding", [((3, 3), (1, 1), "VALID"),
                                                    ((3, 3), (1, 1), "SAME"),
                                                    ((3, 3), (2, 2), "SAME"),
                                                    ((4, 4), (4, 4), "VALID"),
                                                    ((3, 3), (2, 2), ((1, 0), (0, 1)))])
def test_quant_conv2d_wo_matches_jax(kernel, strides, padding):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 10, 3)).astype(np.float32)
    w = rng.integers(-128, 128, size=(*kernel, 3, 6)).astype(np.int8)
    w_s = rng.uniform(0.001, 0.02, size=(6,)).astype(np.float32)
    w_z = rng.uniform(-2, 2, size=(6,)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = np.asarray(jqconv.quant_conv2d_wo(jnp.asarray(x), jnp.asarray(w), jnp.asarray(w_s),
                                             jnp.asarray(w_z), jnp.asarray(b), strides=strides,
                                             padding=padding))
    got = tqconv.quant_conv2d_wo(_t(x), _t(w), _t(w_s), _t(w_z), _t(b), strides=strides,
                                 padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("awq,group", [(True, 0), (False, 9), (True, 9), (True, 54)])
def test_quant_conv2d_wo_awq_and_group_layouts_match_jax(awq, group):
    """The AWQ deploy layout (``awq_recip`` per in-channel folded into the
    dequantized weight) and the ``q_group_size`` grid (N * K/g scales,
    groups along the flattened (kh*kw*ci) axis of each out channel) give
    JAX's conv: float32 convolutions summed in another order, rtol 1e-5 /
    atol 1e-5."""
    rng = np.random.default_rng(13 + group)
    x = rng.normal(size=(2, 9, 10, 6)).astype(np.float32)
    w = rng.integers(-8, 8, size=(3, 3, 6, 5)).astype(np.int8)
    n_s = 5 * 54 // group if group else 5
    w_s = rng.uniform(0.001, 0.02, size=(n_s,)).astype(np.float32)
    w_z = rng.uniform(-2, 2, size=(n_s,)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    recip = rng.uniform(0.5, 2.0, size=(6,)).astype(np.float32) if awq else None
    kw = dict(strides=(2, 2), padding="SAME", group_size=group)
    want = np.asarray(jqconv.quant_conv2d_wo(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(w_s), jnp.asarray(w_z), jnp.asarray(b),
        awq_recip=None if recip is None else jnp.asarray(recip), **kw))
    got = tqconv.quant_conv2d_wo(_t(x), _t(w), _t(w_s), _t(w_z), _t(b),
                                 awq_recip=None if recip is None else _t(recip), **kw)
    assert tuple(got.shape) == want.shape == (2, 5, 5, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_awq_conv(x, weight, activation, bias_correct=None):
    """A 3 x 3 AWQ conv (16 out channels, odd Ci 3: int8 storage) built and
    calibrated in the JAX package: its variables after one calibrate step
    and its deploy variables."""
    from quantize_tpu.nn.layers import LayerQuantCfg as JaxLayerQuantCfg
    from quantize_tpu.nn.layers import QuantConv as JaxQuantConv

    jm = JaxQuantConv(features=16, kernel_size=(3, 3), quant=JaxLayerQuantCfg(
        weight=weight, activation=activation, bias_correct=bias_correct))
    variables = dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mode="calibrate"))
    variables.pop("taps", None)
    _, upd = jm.apply(variables, jnp.asarray(x), mode="calibrate", mutable=["qobs", "qparams"])
    variables.update(upd)
    _, upd = jm.apply(variables, jnp.asarray(x), mode="pack", mutable=["packed"])
    return jm, jax.device_get(variables), jax.device_get({**variables, **upd})


@pytest.mark.parametrize("group", [0, 9])
def test_awq_packed_conv_loaded_from_jax_matches_jax(group):
    """A W4 weight-only AWQ conv packed by the JAX package carries
    ``packed/awq_recip``, which both packages fold into the dequantized
    weight: loaded into the port, its packed output is JAX's (rtol 1e-5 /
    atol 1e-5, float32 convolutions), per out channel and per group."""
    from quantize_tpu_torch.nn.layers import LayerQuantCfg, QuantConv

    weight = {"n_bits": 4, "symmetric": True, "signed": True, "granularity": "channel",
              "range": {"name": "awq", "grid": 8, "q_group_size": group or -1}}
    x = np.random.default_rng(7).normal(size=(2, 8, 8, 3)).astype(np.float32)  # odd Ci: w_int
    jm, _, deploy = _jax_awq_conv(x, weight, {"n_bits": 32})
    assert {"awq_recip", "w_int"} <= set(deploy["packed"])
    assert deploy["packed"]["w_scale"].shape == ((16 * 27 // group,) if group else (16,))
    want = np.asarray(jm.apply(deploy, jnp.asarray(x), mode="packed"))
    tm = QuantConv(3, 16, kernel_size=(3, 3),
                   quant=LayerQuantCfg(weight=weight, activation={"n_bits": 32}), device="cpu")
    convert.from_jax_variables(tm, deploy)
    with torch.no_grad():
        got = tm(_t(x), mode="packed").numpy()
    assert got.shape == want.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer", ["dense", "conv"])
@pytest.mark.parametrize("group,act_bits", [(0, 32), (9, 32), (9, 8)])
def test_awq_and_bias_correct_layers_calibrate_pack_and_serve_as_jax(layer, group, act_bits):
    """An AWQ W4 layer (grid 8; ``q_group_size`` 9 or per out channel) with
    bias correction, from JAX's initial parameters: one calibration step
    gives JAX's observer state, scale/zero and awq_scale (rtol 1e-5: float32
    sums in another order), quant mode JAX's output within one quant step
    on at most 1% of the elements (tests/test_golden_layers.py's allowance),
    and pack JAX's integer weight (on at most 1% of the elements, the same
    flips), awq_recip, bias and scales; the packed forward on JAX's deploy
    buffers is JAX's output (rtol 1e-5). With 8-bit activations the AWQ
    layer still serves weight-only: the activation fake-quantized."""
    from quantize_tpu.nn.layers import LayerQuantCfg as JaxLayerQuantCfg
    from quantize_tpu.nn.layers import QuantDense as JaxQuantDense
    from quantize_tpu_torch.nn.layers import LayerQuantCfg, QuantConv, QuantDense

    weight = {"n_bits": 4, "symmetric": True, "signed": True, "granularity": "channel",
              "range": {"name": "awq", "grid": 8, "q_group_size": group or -1}}
    act = ({"n_bits": 32} if act_bits == 32 else
           {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}})
    bc = {"momentum": 0.1}
    rng = np.random.default_rng(group + act_bits)
    if layer == "conv":
        x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
        jm, variables, deploy = _jax_awq_conv(x, weight, act, bc)
        tm = QuantConv(3, 16, kernel_size=(3, 3), quant=LayerQuantCfg(
            weight=weight, activation=act, bias_correct=bc), device="cpu")
    else:
        x = rng.normal(size=(20, 18)).astype(np.float32)
        jm = JaxQuantDense(features=16, quant=JaxLayerQuantCfg(weight=weight, activation=act,
                                                               bias_correct=bc))
        variables = dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mode="calibrate"))
        variables.pop("taps", None)
        _, upd = jm.apply(variables, jnp.asarray(x), mode="calibrate", mutable=["qobs", "qparams"])
        variables = jax.device_get({**variables, **upd})
        _, upd = jm.apply(variables, jnp.asarray(x), mode="pack", mutable=["packed"])
        deploy = jax.device_get({**variables, **upd})
        tm = QuantDense(18, 16, quant=LayerQuantCfg(weight=weight, activation=act,
                                                    bias_correct=bc), device="cpu")
    # the state after JAX's init (its one calibrate pass), then one step each
    j0 = jax.device_get(dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mode="calibrate")))
    j0.pop("taps", None)
    convert.from_jax_variables(tm, j0)
    with torch.no_grad():
        tm(_t(x), mode="calibrate")
    mine = convert.to_numpy(tm)
    for col in ("qparams", "qobs"):
        m, t = convert.flatten(mine[col]), convert.flatten(variables[col])
        assert set(m) == set(t), col
        for key, val in t.items():
            np.testing.assert_allclose(m[key], val, rtol=1e-5, atol=1e-7, err_msg=key)
    assert "bias_correct_EX/EX" in convert.flatten(mine["qobs"])
    convert.from_jax_variables(tm, variables)
    step = float(np.max(variables["qparams"]["w_quantizer"]["scale"])) * float(np.abs(x).sum())
    with torch.no_grad():
        got = tm(_t(x), mode="quant").numpy()
        want = np.asarray(jm.apply(variables, jnp.asarray(x), mode="quant"))
        off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
        assert off.mean() <= 0.01 and np.abs(got - want).max() <= step
        tm(_t(x), mode="pack")
    m, t = convert.flatten(convert.to_numpy(tm)["packed"]), convert.flatten(deploy["packed"])
    assert set(m) == set(t) and "awq_recip" in t
    for key, val in t.items():
        assert m[key].dtype == np.asarray(val).dtype, key
        if key == "w_int":
            assert np.mean(m[key] != val) <= 0.01
        else:
            np.testing.assert_allclose(m[key], val, rtol=1e-5, atol=1e-6, err_msg=key)
    convert.from_jax_variables(tm, deploy)
    with torch.no_grad():
        got = tm(_t(x), mode="packed").numpy()
    want = np.asarray(jm.apply(deploy, jnp.asarray(x), mode="packed"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# A tiny ViT, weight-only W4
# ---------------------------------------------------------------------------

def _vit_kw(hidden):
    return dict(image_size=32, patch_size=8, num_layers=2, num_heads=2, hidden_dim=hidden,
                mlp_dim=2 * hidden, num_classes=5)


@pytest.fixture(scope="module", params=[32, 128])
def vit_case(request):
    """Two layers, two heads, image 32, patch 8 (S = 17 padded to 24), batch
    2: hidden 32 (JAX's LayerNorm on its jnp path) and 128 (its Pallas
    LayerNorm kernel, interpret mode). Both packages pack from the JAX
    package's calibrated variables."""
    hidden = request.param
    cfg = _cfg(4)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    jm = JViT(ctx=JaxQuantCtx(cfg), **_vit_kw(hidden))
    v1 = dict(jax.jit(lambda k, xc: jm.init(k, xc, mode="calibrate"))(
        jax.random.PRNGKey(0), jnp.asarray(x_cal)))
    v1.pop("taps", None)
    v1 = jax.device_get(v1)
    deploy = jax.device_get(jax.jit(lambda v, xs: jax_pack_model(jm, v, xs))(v1, xj))

    tm = VisionTransformer(ctx=qtt.QuantCtx(cfg), device="cpu", **_vit_kw(hidden))
    convert.from_jax_variables(tm, v1)
    port_deploy = qtt.pack_model(tm, x, device="cpu")
    before = launch_counts()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), mode="packed").float().numpy()
        sim = tm(torch.from_numpy(x), mode="quant").numpy()
    want = np.asarray(jm.apply(deploy, xj, mode="packed"), np.float32)

    # the JAX deploy variables loaded into a fresh port model
    fresh = VisionTransformer(ctx=qtt.QuantCtx(cfg), device="cpu", **_vit_kw(hidden))
    convert.from_jax_variables(fresh, deploy)
    with torch.no_grad():
        from_jax = fresh(torch.from_numpy(x), mode="packed").float().numpy()
    return {"hidden": hidden, "packed": (got, want), "sim": sim, "from_jax": from_jax,
            "buffers": (convert.flatten(convert.to_numpy(tm)["packed"]),
                        convert.flatten(deploy["packed"])),
            "deploy_keys": ({c: set(v) for c, v in port_deploy.items()},
                            {c: set(convert.flatten(v)) for c, v in deploy.items()}),
            "launches_unchanged": launch_counts() == before}


def test_weight_only_vit_deploy_buffers_are_bit_equal(vit_case):
    """w_p4 (or w_int for the odd-channel patch conv), w_scale, w_zero,
    bias and col_sum, and no activation buffers or corr_a."""
    mine, theirs = vit_case["buffers"]
    assert set(mine) == set(theirs)
    assert "conv_proj/w_int" in theirs and "head/w_p4" in theirs
    assert "encoder_layer_0/self_attention/q_proj/w_p4" in theirs
    assert not any(k.endswith(("a_scale", "a_zero", "corr_a")) for k in theirs)
    for key, val in theirs.items():
        assert mine[key].dtype == np.asarray(val).dtype, key
        np.testing.assert_array_equal(mine[key], val, err_msg=key)
    mine_keys, their_keys = vit_case["deploy_keys"]
    assert mine_keys == their_keys


def test_weight_only_vit_packed_logits_match_jax(vit_case):
    got, want = vit_case["packed"]
    assert got.shape == want.shape == (2, 5) and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4  # seen: module docstring
    # the JAX deploy variables loaded with from_jax_variables give the same logits
    np.testing.assert_array_equal(vit_case["from_jax"], got)
    assert vit_case["launches_unchanged"]


def test_weight_only_vit_packed_within_the_quant_simulation_band(vit_case):
    """The packed forward (tanh GELU) against the quant simulation (erf
    GELU) on the same weights: tests/test_vit.py's band, rtol 2e-2 /
    atol 4e-2."""
    got, _ = vit_case["packed"]
    np.testing.assert_allclose(got, vit_case["sim"], rtol=2e-2, atol=4e-2)


def test_weight_only_vit_launches_k5_per_projection(monkeypatch):
    """Every dense layer takes the weight-only branch: 3 q/k/v projections,
    the out-projection, fc1 and fc2 per layer and the head, each one K5
    call (2 layers: 13), and the patch conv takes quant_conv2d_wo."""
    calls = {"wo_gemm": 0, "quant_conv2d_wo": 0}
    orig_wo, orig_conv = tqm.wo_gemm, tqconv.quant_conv2d_wo
    import quantize_tpu_torch.nn.layers as layers

    def wo(*a):
        calls["wo_gemm"] += 1
        return orig_wo(*a)

    def conv(*a, **kw):
        calls["quant_conv2d_wo"] += 1
        return orig_conv(*a, **kw)

    monkeypatch.setattr(tqm, "wo_gemm", wo)
    monkeypatch.setattr(layers, "quant_conv2d_wo", conv)
    x = np.random.default_rng(3).normal(size=(1, 32, 32, 3)).astype(np.float32)
    tm = VisionTransformer(ctx=qtt.QuantCtx(_cfg(4)), device="cpu", **_vit_kw(32))
    qtt.init_model(tm, x, seed=0, device="cpu")
    qtt.pack_model(tm, x, device="cpu")
    with torch.no_grad():
        out = tm(torch.from_numpy(x), mode="packed")
    assert tuple(out.shape) == (1, 5)
    assert calls == {"wo_gemm": 13, "quant_conv2d_wo": 1}


# ---------------------------------------------------------------------------
# A tiny ResNet-18, weight-only W8: the weight-only conv's residual tail
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet_case():
    cfg = _cfg(8)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    jm = JAX_MODELS.build("resnet18", num_classes=10, ctx=JaxQuantCtx(cfg))
    v0 = dict(jax.jit(lambda k, xs: jm.init(k, xs, mode="calibrate"))(jax.random.PRNGKey(0), xj))
    v0.pop("taps", None)
    v0 = jax.device_get(v0)
    deploy = jax.device_get(jax.jit(lambda v, xs: jax_pack_model(jm, v, xs))(v0, xj))
    tm = qtt.MODELS.build("resnet18", num_classes=10, ctx=qtt.QuantCtx(cfg), device="cpu")
    convert.from_jax_variables(tm, v0)
    qtt.pack_model(tm, x, device="cpu")
    out = {"buffers": (convert.flatten(convert.to_numpy(tm)["packed"]),
                       convert.flatten(deploy["packed"]))}
    for fused in (False, True):
        with jax_fused_residual(fused):
            want = np.asarray(jm.apply(deploy, xj, mode="packed"))
        with qtt.fused_residual(fused), torch.no_grad():
            got = tm(torch.from_numpy(x), mode="packed").numpy()
        out[fused] = (got, want)
    return out


def test_weight_only_resnet_pack_buffers_are_bit_equal(resnet_case):
    mine, theirs = resnet_case["buffers"]
    assert set(mine) == set(theirs) and "conv1/w_int" in theirs
    assert not any(k.endswith(("a_scale", "corr_a")) for k in theirs)
    for key, val in theirs.items():
        np.testing.assert_array_equal(mine[key], val, err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
def test_weight_only_resnet_packed_logits_match_jax(resnet_case, fused):
    """Fused on, each block's last conv adds the residual and the ReLU in
    the weight-only branch's unfused tail; off, the block does."""
    got, want = resnet_case[fused]
    assert got.shape == want.shape == (2, 10) and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4  # seen: module docstring
