"""The ViT slice end to end: a tiny ViT W4A8 init -> calibrate -> pack ->
packed forward in the port, held against the JAX package on the CPU.

Two layers, two heads, hidden 32 (every LayerNorm on JAX's jnp path) and
hidden 128 (JAX's Pallas LayerNorm kernels, interpret mode), image 32 and
patch 8 (S = 17 padded to 24), 5 classes, batch 2, W4A8 as ``bench.py``:
int4 symmetric per-channel MinMax weights (the out-projection's range
forced to MSE), int8 asymmetric per-tensor MinMax activations. JAX
variables are carried into the port with quantize_tpu_torch.convert.

* Calibrated qparams (MinMax and the out-projection's MSE grid search):
  rtol 1e-5 (float32 reassociation; seen 3.0e-7 at hidden 32 and 2.6e-7 at
  hidden 128).
* Pack from the same calibrated variables: every buffer bit-equal.
* Packed logits on the same deploy buffers, f32 carry: criterion 1e-3 of
  max|JAX logits|, seen 0.0 at both widths. bf16 carry (hidden 32):
  criterion 5e-2, seen 6.9e-3: one bf16 ulp of a float op in another
  order (the out-projection's f32 product, the GELU) moves an int8 rounding
  of the next quantize, as it moves JAX's own bf16 result against f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.deploy import model_size_bytes as jax_model_size_bytes
from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models.vit import MLPBlock as JMLPBlock
from quantize_tpu.models.vit import VisionTransformer as JViT
from quantize_tpu.nn.attention import QuantMultiheadAttention as JMHA
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.nn.layers import LayerQuantCfg as JCfg
from quantize_tpu.nn.precision import packed_carry as jax_packed_carry
import quantize_tpu_torch as qtt
import quantize_tpu_torch.nn.attention as port_attention
from quantize_tpu_torch import convert
from quantize_tpu_torch.models import MODELS
from quantize_tpu_torch.models.vit import MLPBlock, VisionTransformer
from quantize_tpu_torch.nn.attention import QuantMultiheadAttention
from quantize_tpu_torch.nn.layers import LayerQuantCfg, QuantConv, QuantDense
from quantize_tpu_torch.ops import launch_counts

torch.set_num_threads(2)

WEIGHT = {"n_bits": 4, "symmetric": True, "signed": True, "granularity": "channel",
          "range": {"name": "minmax"}}
ACT = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}
CFG = {"default": {"weight": WEIGHT, "activation": ACT, "bn_folding": True}}


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / np.max(np.abs(b)))


def _vit_kw(hidden):
    return dict(image_size=32, patch_size=8, num_layers=2, num_heads=2, hidden_dim=hidden,
                mlp_dim=2 * hidden, num_classes=5)


def _packed_port(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x), mode="packed").float().numpy()


@pytest.fixture(scope="module", params=[32, 128])
def case(request):
    hidden = request.param
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    x_cal = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    jm = JViT(ctx=JaxQuantCtx(CFG), **_vit_kw(hidden))
    # init runs one calibrate pass over x_cal from fresh observers; init and
    # pack are jitted (one compile instead of one per eager op), the packed
    # forwards run eagerly, as the port runs its ops
    v1 = dict(jax.jit(lambda k, xc: jm.init(k, xc, mode="calibrate"))(
        jax.random.PRNGKey(0), jnp.asarray(x_cal)))
    v1.pop("taps", None)
    v1 = jax.device_get(v1)
    out = {"hidden": hidden}

    tm = VisionTransformer(ctx=qtt.QuantCtx(CFG), device="cpu", **_vit_kw(hidden))
    convert.from_jax_variables(tm, {"params": v1["params"]})
    qtt.calibrate_model(tm, [x_cal], device="cpu")
    out["calibrated"] = (convert.to_numpy(tm), v1)
    out["variable_keys"] = ({c: set(convert.flatten(v)) for c, v in convert.to_numpy(tm).items()},
                            {c: set(convert.flatten(v)) for c, v in v1.items()})

    convert.from_jax_variables(tm, v1)
    with torch.no_grad():
        out["quant"] = tm(torch.from_numpy(x), mode="quant").numpy()
    deploy = jax.device_get(jax.jit(lambda v, xs: jax_pack_model(jm, v, xs))(v1, xj))
    port_deploy = qtt.pack_model(tm, x, device="cpu")
    out["packed_buffers"] = (convert.flatten(convert.to_numpy(tm)["packed"]),
                             convert.flatten(jax.device_get(deploy["packed"])))
    out["deploy_keys"] = ({c: set(v) for c, v in port_deploy.items()},
                          {c: set(convert.flatten(v)) for c, v in deploy.items()})
    out["deploy_bytes"] = (qtt.model_size_bytes(port_deploy), jax_model_size_bytes(deploy))
    before = launch_counts()
    for carry in ("float32", "bfloat16") if hidden == 32 else ("float32",):
        with jax_packed_carry(carry):
            want = np.asarray(jm.apply(deploy, xj, mode="packed"), np.float32)
        with qtt.packed_carry(carry):
            out[("packed", carry)] = (_packed_port(tm, x), want)
    out["launches_unchanged"] = launch_counts() == before
    out["model"], out["x"], out["deploy"] = tm, x, deploy
    return out


def test_variables_have_the_flax_names(case):
    mine, theirs = case["variable_keys"]
    assert mine == theirs
    assert {"class_token", "pos_embedding"} <= mine["params"]
    assert "encoder_layer_1/self_attention/out_proj/kernel" in mine["params"]


def test_calibrated_qparams_and_observers_match(case):
    port, jax_vars = case["calibrated"]
    for col in ("qparams", "qobs"):
        mine, theirs = convert.flatten(port[col]), convert.flatten(jax_vars[col])
        assert set(mine) == set(theirs), col
        for key, val in theirs.items():
            if key.endswith("count"):
                np.testing.assert_array_equal(mine[key], val, err_msg=key)
            else:
                np.testing.assert_allclose(mine[key], val, rtol=1e-5, atol=1e-7, err_msg=key)
    # the out-projection's weight range is the MSE search, not MinMax
    key = "encoder_layer_0/self_attention/out_proj/w_quantizer/scale"
    kernel = convert.flatten(port["params"])["encoder_layer_0/self_attention/out_proj/kernel"]
    assert np.any(convert.flatten(port["qparams"])[key] < np.abs(kernel).max(0) / 7 * (1 - 1e-6))


def test_pack_buffers_are_bit_equal(case):
    mine, theirs = case["packed_buffers"]
    assert set(mine) == set(theirs)
    for suffix in ("w_p4", "w_int", "col_sum", "corr_a", "w_scale", "a_scale"):
        assert any(k.endswith(suffix) for k in theirs), suffix
    assert "conv_proj/w_int" in theirs and "head/w_p4" in theirs
    for key, val in theirs.items():
        assert mine[key].dtype == np.asarray(val).dtype, key
        np.testing.assert_array_equal(mine[key], val, err_msg=key)


def test_deploy_variables_have_the_jax_layout(case):
    mine, theirs = case["deploy_keys"]
    assert mine == theirs
    assert "encoder_layer_0/mlp/linear1/kernel" not in mine["params"]
    assert case["deploy_bytes"][0] == case["deploy_bytes"][1]


@pytest.mark.parametrize("carry,limit", [("float32", 1e-3), ("bfloat16", 5e-2)])
def test_packed_logits_match_jax(case, carry, limit):
    """bf16 carry at hidden 32 (at 128 the f32 carry alone: JAX's bf16
    interpret-mode kernels would double this file's run time)."""
    if ("packed", carry) not in case:
        assert case["hidden"] == 128 and carry == "bfloat16"
        carry, limit = "float32", 1e-3
    got, want = case[("packed", carry)]
    assert got.shape == want.shape == (2, 5) and np.isfinite(got).all()
    assert _rel(got, want) <= limit  # seen: module docstring


def test_packed_within_the_quant_simulation_band(case):
    """tests/test_vit.py's band for packed (tanh GELU) against the quant
    simulation (erf GELU): rtol 2e-2 / atol 4e-2. CPU tensors launch no
    kernel."""
    packed, _ = case[("packed", "float32")]
    np.testing.assert_allclose(packed, case["quant"], rtol=2e-2, atol=4e-2)
    assert case["launches_unchanged"]


def test_fused_qkv_matches_per_projection(case, monkeypatch):
    """The fused q/k/v matmul (K7 -> K4) against three projections after an
    unfused LayerNorm (K6, then one quantize each): same int8 inputs, same
    integer sums; rtol 1e-5 / atol 1e-5 as tests/test_vit.py."""
    fused, _ = case[("packed", "float32")]
    monkeypatch.setattr(port_attention, "_fused_qkv_packed", lambda *a, **k: None)
    separate = _packed_port(case["model"], case["x"])
    np.testing.assert_allclose(separate, fused, rtol=1e-5, atol=1e-5)


def _assert_kmajor_copies(model):
    """Each int4 W4A8 QuantDense holds K4's K-major copy of its packed
    weight as a non-persistent buffer outside the packed collection; the
    weight-only out-projections (K5) hold none."""
    dense = [m for m in model.modules() if isinstance(m, QuantDense) and m.has_var("packed", "w_p4")]
    w4a8 = [m for m in dense if m.a_spec.enabled]
    assert len(dense) == 2 * 6 + 1 and len(w4a8) == 2 * 5 + 1  # q, k, v, fc1, fc2; the head
    assert not any(hasattr(m, "w_p4_kmajor") for m in dense if not m.a_spec.enabled)
    for m in w4a8:
        w_p4 = m.get_var("packed", "w_p4")
        assert m.w_p4_kmajor.is_contiguous() and torch.equal(m.w_p4_kmajor, w_p4.t())
        assert "w_p4_kmajor" not in m.state_dict()
        assert not any("kmajor" in leaf for _, leaf, _ in m.own_vars())


def test_kmajor_copy_is_made_at_pack_and_at_load(case):
    """After ``pack_model`` and after loading JAX's deploy variables into a
    fresh model; the loaded model's packed logits equal JAX's at f32 carry."""
    _assert_kmajor_copies(case["model"])
    fresh = VisionTransformer(ctx=qtt.QuantCtx(CFG), device="cpu", **_vit_kw(case["hidden"]))
    convert.from_jax_variables(fresh, case["deploy"])
    _assert_kmajor_copies(fresh)
    assert "kmajor" not in str(sorted(convert.flatten(convert.to_numpy(fresh)["packed"])))
    got = _packed_port(fresh, case["x"])
    assert np.array_equal(got, case[("packed", "float32")][1])


def test_packed_logits_bit_equal_through_the_kmajor_copy(case, monkeypatch):
    """The fused q/k/v as the wgmma route receives it (the K-major copies
    alone): packed logits still bit-equal to JAX's at f32 carry."""
    fused = port_attention.fused_w4_operands
    seen = []

    def as_on_the_card(bufs, device, k):
        w, w_km = fused(bufs, torch.device("cuda"), k)
        seen.append(w is None and w_km is not None)
        return w, w_km

    monkeypatch.setattr(port_attention, "fused_w4_operands", as_on_the_card)
    got = _packed_port(case["model"], case["x"])
    assert seen == [True, True]
    assert np.array_equal(got, case[("packed", "float32")][1])


def test_mlp_gelu_is_tanh_in_packed_mode_and_erf_elsewhere(case, monkeypatch):
    seen = []
    gelu = torch.nn.functional.gelu

    def spy(x, approximate="none"):
        seen.append(approximate)
        return gelu(x, approximate=approximate)

    monkeypatch.setattr(torch.nn.functional, "gelu", spy)
    model, x = case["model"], torch.from_numpy(case["x"])
    with torch.no_grad():
        model(x, mode="packed")
        assert seen == ["tanh", "tanh"]
        seen.clear()
        for mode in ("quant", "fp32"):
            model(x, mode=mode)
        assert seen == ["none"] * 4


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    """The MLP block in float (FP32 config): erf GELU in fp32 mode as JAX's
    ``nn.gelu(approximate=False)``; the tanh form checked directly against
    ``jax.nn.gelu(approximate=True)``. rtol 1e-6 / atol 1e-6."""
    x = np.random.default_rng(3).normal(scale=2, size=(3, 7, 16)).astype(np.float32)
    if approximate:
        want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
        got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    else:
        jm = JMLPBlock(ctx=JaxQuantCtx.fp32(), qpath="/encoder/layers/encoder_layer_0/mlp",
                       hidden_dim=24, out_dim=16)
        v = jax.device_get(dict(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))))
        tm = MLPBlock(qtt.QuantCtx(None, enabled=False), "/encoder/layers/encoder_layer_0/mlp",
                      16, 24, 16, device="cpu")
        convert.from_jax_variables(tm, v)
        want = np.asarray(jm.apply(v, jnp.asarray(x), mode="fp32"))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), mode="fp32").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _mha_pair(w_bits):
    cfg = {"weight": {**WEIGHT, "n_bits": w_bits}, "activation": ACT}
    jm = JMHA(64, 2, quant=JCfg(**cfg))
    tm = QuantMultiheadAttention(64, 2, quant=LayerQuantCfg(**cfg), device="cpu")
    x = np.random.default_rng(w_bits).normal(size=(2, 13, 64)).astype(np.float32)
    xj = jnp.asarray(x)
    v = dict(jm.init(jax.random.PRNGKey(0), xj, mode="calibrate"))
    v.pop("taps", None)
    v = jax.device_get(v)
    convert.from_jax_variables(tm, v)
    deploy = jax_pack_model(jm, v, xj)
    qtt.pack_model(tm, x, device="cpu")
    return jm, tm, v, deploy, x


def test_attention_module_paths_match_jax():
    """QuantMultiheadAttention (W4 weights) against JAX on the same
    variables: 3-D (B, S, E) input with S = 13 through the packed
    fused-kernel path (S padded to 16 inside), the causal mask, an additive
    array mask (the einsum path on the fused projections), the quant mode's
    einsum path, and 2-D rows with seq_len and valid_len in both modes.
    rtol 1e-5 / atol 1e-5 (float32 products in another order; a flipped
    int8 rounding would show as a whole step)."""
    jm, tm, v, deploy, x = _mha_pair(4)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    additive = np.where(np.random.default_rng(5).random((1, 1, 13, 13)) < 0.2, -1e9,
                        0.0).astype(np.float32)
    rows = np.concatenate([x, np.zeros((2, 3, 64), np.float32)], axis=1).reshape(32, 64)
    cases = [(xj, xt, {"mask": None}), (xj, xt, {"mask": "causal"}),
             (xj, xt, {"mask": (jnp.asarray(additive), torch.from_numpy(additive))}),
             (jnp.asarray(rows), torch.from_numpy(rows), {"seq_len": 16, "valid_len": 13})]
    with torch.no_grad():
        for xj_, xt_, kw in cases:
            kj = {k: (val[0] if isinstance(val, tuple) else val) for k, val in kw.items()}
            kt = {k: (val[1] if isinstance(val, tuple) else val) for k, val in kw.items()}
            for mode, variables in (("packed", deploy), ("quant", v)):
                want = np.asarray(jm.apply(variables, xj_, mode=mode, **kj))
                got = tm(xt_, mode=mode, **kt).numpy()
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{mode} {sorted(kw)} {kw.get('mask')!s:.10}")


def test_attention_fused_qkv_module_level_matches_per_projection(monkeypatch):
    """tests/test_vit.py's module-level check, W4 weights: fused q/k/v vs
    three projections, rtol 1e-5 / atol 1e-5."""
    _, tm, _, _, x = _mha_pair(4)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        fused = tm(xt, mode="packed").numpy()
        monkeypatch.setattr(port_attention, "_fused_qkv_packed", lambda *a, **k: None)
        separate = tm(xt, mode="packed").numpy()
    np.testing.assert_allclose(separate, fused, rtol=1e-5, atol=1e-5)


def test_vit_family_is_registered_with_flax_paths():
    for name in ("vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14"):
        assert callable(MODELS.lookup(name))
    m = MODELS.build("vit_b_16", num_classes=3, ctx=qtt.QuantCtx(CFG), device="meta",
                     image_size=32)
    names = dict(m.named_modules())
    assert "encoder_layer_11.self_attention.out_proj" in names and "encoder_layer_12" not in names
    assert tuple(m.get_var("params", "pos_embedding").shape) == (1, 5, 768)


def test_even_channel_int4_conv_packs_w_p4c_as_jax():
    """An int4 conv with an even input width stores its weight as int4
    pairs along the input channels (``packed/w_p4c``): the bytes JAX packs,
    the deploy variables JAX's, and the packed forward, from the port's pack
    and from JAX's deploy variables, bit-equal to eager JAX's."""
    from quantize_tpu.nn.layers import QuantConv as JQuantConv

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    jm = JQuantConv(8, (2, 2), strides=(2, 2), padding="VALID",
                    quant=JCfg(weight=WEIGHT, activation=ACT))
    v = dict(jm.init(jax.random.PRNGKey(2), jnp.asarray(x), mode="calibrate"))
    v.pop("taps", None)
    v = jax.device_get(v)
    deploy = jax.device_get(jax_pack_model(jm, v, jnp.asarray(x)))
    want = np.asarray(jm.apply(deploy, jnp.asarray(x), mode="packed"))
    conv = QuantConv(4, 8, (2, 2), (2, 2), "VALID",
                     quant=LayerQuantCfg(weight=WEIGHT, activation=ACT), device="cpu")
    convert.from_jax_variables(conv, v)
    port_deploy = qtt.pack_model(conv, x, device="cpu")
    assert {c: set(d) for c, d in port_deploy.items()} == \
        {c: set(convert.flatten(d)) for c, d in deploy.items()}
    assert "w_p4c" in port_deploy["packed"] and "w_int" not in port_deploy["packed"]
    np.testing.assert_array_equal(port_deploy["packed"]["w_p4c"].numpy(),
                                  deploy["packed"]["w_p4c"])
    assert port_deploy["packed"]["w_p4c"].shape == (2, 2, 2, 8)
    fresh = QuantConv(4, 8, (2, 2), (2, 2), "VALID",
                      quant=LayerQuantCfg(weight=WEIGHT, activation=ACT), device="cpu")
    convert.from_jax_variables(fresh, deploy)
    with torch.no_grad():
        for m in (conv, fresh):
            np.testing.assert_array_equal(m(torch.from_numpy(x), mode="packed").numpy(), want)
