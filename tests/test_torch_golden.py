"""The reference's golden fixtures replayed through the port on the CPU.

``tests/golden/{observers,layers,models}.json`` record the original torch
library's own numbers on seeded tensors (``tests/test_golden_parity.py``,
``test_golden_layers.py`` and ``test_golden_models.py`` replay them through
the JAX package). Here the same tensors go through quantize_tpu_torch, at
those tests' tolerances:

* observers: every case (scale rtol 1e-4 / atol 1e-6, zero rtol 1e-4 /
  atol 1e-4; AWQ's awq_scale rtol 1e-4 / atol 1e-6; the bias correction
  rtol 1e-4 / atol 1e-6). Fixture layout: weights channel axis 0,
  activations 1; AWQ's (out, in) weight is transposed to (in, out);
* layers: the quantizer simulation and pack, conv (plain, BN folded,
  into_scale, bias correction, W4A8 MSE, stride 2, W4 weight-only,
  asymmetric weights, grouped: ``conv_w8a8_grouped``), linear, attention,
  QuantReLU and QuantMaxPool, with
  the same bounded allowance for quant-step flips, and the four
  ``adaround_*`` cases (h(V), the regularization at β 20 and 2, V's
  initialization and the AdaRound rounding) at
  ``tests/test_golden_layers.py``'s tolerances;
* models: the ResNet-18 pipelines (torchvision-layout weights from
  ``tests/golden/weightgen.py`` through ``init_model(torch_state_dict=...)``,
  then calibration), the two-block pre-LN attention stacks and the
  MobileNet-style stack (``mobile_stack_w8a8``: BN-folded depthwise and
  pointwise convs, a residual block) and the reference's own CLIP towers
  (``clip_vit_tower_w8a8``: the ViT tower, its LayerNorms live;
  ``clip_rn_tower_w8a8``: ModifiedResNet with BN folded and the attention
  pool scoped to 32 bits, whose reference quantizers are inert): every
  quantizer's calibrated scale/zero (rtol 2e-3), the fp32 logits (2e-3) and
  the quant logits within the network's own quantization noise with the
  same argmax. Every model case replays.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.nn.attention import QuantMultiheadAttention
from quantize_tpu_torch.nn.layers import (LayerQuantCfg, QuantConv, QuantDense, QuantMaxPool,
                                          QuantReLU)
from quantize_tpu_torch.nn.norm import FusedLayerNorm
from quantize_tpu_torch.nn.quantizer import Quantizer, awq_group
from quantize_tpu_torch.quant import adaround
from quantize_tpu_torch.quant.observers import AWQ, BiasCorrect, build_observer
from quantize_tpu_torch.quant.qspec import QuantSpec
from quantize_tpu_torch.models.clip.model import CLIPVisionTransformer, ModifiedResNet
from quantize_tpu_torch.models.import_torch import fold_bn

torch.set_num_threads(2)

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "golden"))
from weightgen import gen_input, gen_param  # noqa: E402


def _load(name):
    with open(os.path.join(_HERE, "golden", f"{name}.json")) as f:
        return {c["case"]: c for c in json.load(f)["cases"]}


OBS, LAYERS, MODELS = _load("observers"), _load("layers"), _load("models")


def _gen(seed, shape, gen=None):
    gen = gen or {}
    return (np.random.default_rng(seed).normal(size=shape)
            * gen.get("scale", 1.0) + gen.get("loc", 0.0)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


def _close(ours, ref, rtol=1e-4, atol=1e-4, step=None, name=""):
    """tests/test_golden_layers.py's comparison: allclose, with at most 1% of
    the elements allowed to differ by up to 1.5 quant steps (a float32
    reassociation moving a value across a round() threshold)."""
    ours = np.asarray(ours, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    assert ours.shape == ref.shape, f"{name}: shape {ours.shape} vs {ref.shape}"
    diff = np.abs(ours - ref)
    bad = diff > atol + rtol * np.abs(ref)
    if not bad.any():
        return
    if step is None:
        np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol, err_msg=name)
    assert bad.mean() <= 0.01, f"{name}: {bad.mean():.2%} of elements off (max {diff.max():.4g})"
    assert diff[bad].max() <= step * 1.5, f"{name}: flip {diff[bad].max():.4g} > step {step:.4g}"


# ---------------------------------------------------------------------------
# observers.json
# ---------------------------------------------------------------------------

_STANDARD_OBS = [k for k, c in OBS.items()
                 if c["cfg"].get("name") in ("minmax", "maminmax", "mse", "cross_entropy", "aciq")]


@pytest.mark.parametrize("case", _STANDARD_OBS)
def test_observer_replays_the_reference_golden(case):
    c = OBS[case]
    cfg = dict(c["cfg"])
    name = cfg.pop("name")
    axis = 0 if c["flag"] == "weight" else 1
    kwargs = {k: v for k, v in cfg.items()
              if k in ("percentile", "momentum", "fuse_relu", "grid", "maxshrink", "norm")}
    spec = QuantSpec.from_config({**cfg, "range": {"name": name, **kwargs}}, c["flag"],
                                 channel_axis=axis)
    obs = build_observer(spec)
    assert obs.name == name
    state = obs.init_state(c["shape"][axis] if spec.per_channel else 1)
    for seed in c["seeds"]:
        state, scale, zero = obs(state, _t(_gen(seed, tuple(c["shape"]), c["gen"])))
    np.testing.assert_allclose(_np(scale).reshape(-1), c["scale"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(zero).reshape(-1), c["zero"], rtol=1e-4, atol=1e-4)
    assert (spec.qmin, spec.qmax) == (c["qmin"], c["qmax"])


@pytest.mark.parametrize("case", ["awq_channel_sym_w4", "awq_grouped_w4"])
def test_awq_observer_replays_the_reference_golden(case):
    c = OBS[case]
    cfg = dict(c["cfg"])
    gsize = cfg.pop("q_group_size")
    spec = QuantSpec.from_config({**{k: v for k, v in cfg.items() if k != "name"},
                                  "range": {"name": "awq", "q_group_size": gsize}},
                                 "weight", channel_axis=-1)
    obs = build_observer(spec)
    assert isinstance(obs, AWQ) and obs.q_group_size == gsize
    w = _t(_gen(c["w_seed"], tuple(c["w_shape"]), c["w_gen"]).T)  # (out, in) -> (in, out)
    state = obs.init_state(w.shape[0])
    for seed in c["act_seeds"]:
        x = _t(_gen(seed, tuple(c["act_shape"]), {"scale": 1.0}))
        state, scale, zero, awq_scale = obs(state, w, pre_act=x, apply_fn=lambda wm, a: a @ wm)
    np.testing.assert_allclose(_np(scale).reshape(-1), c["scale"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(zero).reshape(-1), c["zero"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(awq_scale).reshape(-1), c["awq_scale"], rtol=1e-4, atol=1e-6)


def test_bias_correct_replays_the_reference_golden():
    c = OBS["bias_correct_linear"]
    bc = BiasCorrect(momentum=c["cfg"]["momentum"])
    state = bc.init_state((c["act_shape"][1],))
    for seed in c["act_seeds"]:
        state = bc.calibrate(state, _t(_gen(seed, tuple(c["act_shape"]), c["act_gen"])))
    dw = _t(_gen(c["dw_seed"], tuple(c["dw_shape"]), c["dw_gen"]).T)
    bias = bc.correction(state, dw, lambda w, ex: ex @ w)
    np.testing.assert_allclose(_np(bias).reshape(-1), c["bias"], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# layers.json
# ---------------------------------------------------------------------------

_QZ = [k for k, c in LAYERS.items() if c["kind"] == "quantizer_sim"]


@pytest.mark.parametrize("case", _QZ)
def test_quantizer_replays_the_reference_golden(case):
    c = LAYERS[case]
    cfg, flag = dict(c["cfg"]), c["flag"]
    x_ref = _gen(c["seed"], tuple(c["shape"]), c["gen"])
    x = _t(np.moveaxis(x_ref, 0 if flag == "weight" else 1, -1))
    spec = QuantSpec.from_config(cfg, flag, channel_axis=-1)
    g = awq_group(spec)
    n_ch = x.numel() // g if g else spec.n_channels(tuple(x.shape))
    q = Quantizer(spec, n_ch)
    calib_kw = {}
    if cfg.get("range", {}).get("name") == "awq":
        pa = _t(_gen(c["pre_act"]["seed"], tuple(c["pre_act"]["shape"])))
        calib_kw = dict(pre_act=pa, apply_fn=lambda w, a: a @ w)
    q(x, mode="calibrate", **calib_kw)
    if "static_scale" in c:
        q.put_var("qparams", "static_scale", _t(np.asarray(c["static_scale"], np.float32)))
    scale = _np(q.get_var("qparams", "scale")).reshape(-1)
    np.testing.assert_allclose(scale, c["scale"], rtol=1e-4, atol=1e-6, err_msg=f"{case}: scale")
    np.testing.assert_allclose(_np(q.get_var("qparams", "zero")).reshape(-1), c["zero"],
                               rtol=1e-4, atol=1e-4, err_msg=f"{case}: zero")
    if "awq_scale" in c:
        np.testing.assert_allclose(_np(q.get_var("qparams", "awq_scale")).reshape(-1),
                                   c["awq_scale"], rtol=1e-4, atol=1e-6)
    ref_out = np.asarray(c["out"], np.float32).reshape(c["shape"])
    ref_out = np.moveaxis(ref_out, 0 if flag == "weight" else 1, -1)
    step = float(np.max(np.abs(scale))) * float(np.max(c.get("static_scale", [1.0])))
    _close(_np(q(x, mode="quant")), ref_out, rtol=1e-4, atol=1e-5, step=step, name=case)
    if "pack_q" in c:
        qi, sc, zo = q(x, mode="pack")
        ref_q = np.moveaxis(np.asarray(c["pack_q"], np.float32).reshape(c["shape"]), 0, -1)
        assert np.mean(_np(qi) != ref_q) <= 0.01, f"{case}: pack ints"
        np.testing.assert_allclose(_np(sc).reshape(-1), c["pack_scale"], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(_np(zo).reshape(-1), c["pack_zero"], rtol=1e-4, atol=1e-4)


def _layer_cfg(c):
    return LayerQuantCfg(weight=c["w_setting"], activation=c["a_setting"],
                         bias_correct=c.get("bias_correct"),
                         bn_folding=({"into_scale": True} if c.get("into_scale")
                                     else bool(c.get("bn_folding"))) or None)


def _calibrate_and_eval(model, calib_xs, x_eval, packed):
    with torch.no_grad():
        for xb in calib_xs:
            model(xb, mode="calibrate")
        out = _np(model(x_eval, mode="quant"))
        out_p = None
        if packed:
            model(x_eval, mode="pack")
            out_p = _np(model(x_eval, mode="packed"))
    return out, out_p


_CONV = [k for k, c in LAYERS.items() if c["kind"] == "conv_forward"]


@pytest.mark.parametrize("case", _CONV)
def test_conv_replays_the_reference_golden(case):
    c = LAYERS[case]
    w = _gen(c["w_seed"], (c["out_ch"], c["in_ch"] // c["groups"], c["k"], c["k"]),
             {"scale": 0.5})
    b = _gen(c["b_seed"], (c["out_ch"],), {"scale": 0.1})
    ss = None
    if c["bn_folding"]:
        s2, s3, s4, s5 = c["bn_seeds"]
        gamma = np.abs(_gen(s2, (c["out_ch"],))) + 0.5
        beta = _gen(s3, (c["out_ch"],), {"scale": 0.2})
        mean = _gen(s4, (c["out_ch"],), {"scale": 0.3})
        var = np.abs(_gen(s5, (c["out_ch"],))) + 0.8
        w, b, ss = fold_bn(w, b, gamma, beta, mean, var, eps=1e-5, into_scale=c["into_scale"])
    p = c["padding"]
    model = QuantConv(c["in_ch"], c["out_ch"], kernel_size=(c["k"], c["k"]),
                      strides=(c["stride"], c["stride"]), padding=[(p, p), (p, p)],
                      feature_group_count=c["groups"], quant=_layer_cfg(c), device="cpu")
    model.put_var("params", "kernel", _t(np.transpose(w, (2, 3, 1, 0))))  # OIHW -> HWIO
    model.put_var("params", "bias", _t(b))
    gen = {"scale": 1.0, "loc": 0.1}
    calib_xs = [_t(_nhwc(_gen(s, tuple(c["x_shape"]), gen))) for s in c["calib_seeds"]]
    x_eval = _t(_nhwc(_gen(c["eval_seed"], tuple(c["x_shape"]), gen)))
    if ss is not None:
        # BN-into-scale installed as the weight quantizer's static_scale after
        # the first calibration batch, as test_golden_layers.py does
        with torch.no_grad():
            model(calib_xs[0], mode="calibrate")
        model.w_quantizer.put_var("qparams", "static_scale", _t(ss))
        calib_xs = calib_xs[1:]
    out, out_p = _calibrate_and_eval(model, calib_xs, x_eval, "packed_out" in c)
    ref = _nhwc(np.asarray(c["out"], np.float32).reshape(c["out_shape"]))
    step = float(np.abs(out).max()) * 0.02 + 0.05
    _close(out, ref, rtol=2e-3, atol=2e-3, step=step, name=case)
    if out_p is not None:
        ref_p = _nhwc(np.asarray(c["packed_out"], np.float32).reshape(c["out_shape"]))
        _close(out_p, ref_p, rtol=2e-3, atol=2e-3, step=step, name=f"{case}:packed")


_LIN = [k for k, c in LAYERS.items() if c["kind"] == "linear_forward"]


@pytest.mark.parametrize("case", _LIN)
def test_linear_replays_the_reference_golden(case):
    c = LAYERS[case]
    w = _gen(c["w_seed"], (c["out_f"], c["in_f"]), {"scale": 0.5})
    b = _gen(c["b_seed"], (c["out_f"],), {"scale": 0.1})
    model = QuantDense(c["in_f"], c["out_f"], quant=_layer_cfg(c), device="cpu")
    model.put_var("params", "kernel", _t(w.T))
    model.put_var("params", "bias", _t(b))
    gen = {"scale": 1.0, "loc": 0.1}
    calib_xs = [_t(_gen(s, tuple(c["x_shape"]), gen)) for s in c["calib_seeds"]]
    x_eval = _t(_gen(c["eval_seed"], tuple(c["x_shape"]), gen))
    out, out_p = _calibrate_and_eval(model, calib_xs, x_eval, "packed_out" in c)
    step = float(np.abs(out).max()) * 0.02 + 0.05
    _close(out, np.asarray(c["out"], np.float32).reshape(out.shape), rtol=2e-3, atol=2e-3,
           step=step, name=case)
    if out_p is not None:
        _close(out_p, np.asarray(c["packed_out"], np.float32).reshape(out.shape), rtol=2e-3,
               atol=2e-3, step=step, name=f"{case}:packed")


def _load_mha(mha, prefix_params):
    for name, (w, b) in prefix_params.items():
        mod = getattr(mha, name)
        mod.put_var("params", "kernel", _t(w.T))
        mod.put_var("params", "bias", _t(b))


_MHA = [k for k, c in LAYERS.items() if c["kind"] == "mha_forward"]


@pytest.mark.parametrize("case", _MHA)
def test_mha_replays_the_reference_golden(case):
    c = LAYERS[case]
    e = c["embed"]
    s0, s1, s2, s3 = c["w_seeds"]
    in_w = _gen(s0, (3 * e, e), {"scale": 0.3})
    in_b = _gen(s1, (3 * e,), {"scale": 0.05})
    out_w = _gen(s2, (e, e), {"scale": 0.3})
    out_b = _gen(s3, (e,), {"scale": 0.05})
    model = QuantMultiheadAttention(e, c["heads"], quant=LayerQuantCfg(
        weight=c["w_setting"], activation=c["a_setting"], bias_correct=c.get("bias_correct")),
        device="cpu")
    _load_mha(model, {"q_proj": (in_w[:e], in_b[:e]), "k_proj": (in_w[e:2 * e], in_b[e:2 * e]),
                      "v_proj": (in_w[2 * e:], in_b[2 * e:]), "out_proj": (out_w, out_b)})

    def to_ours(x):  # (S, B, E) -> (B, S, E)
        return np.transpose(x, (1, 0, 2))

    calib_xs = [_t(to_ours(_gen(s, tuple(c["x_shape"])))) for s in c["calib_seeds"]]
    x_eval = _t(to_ours(_gen(c["eval_seed"], tuple(c["x_shape"]))))
    out, _ = _calibrate_and_eval(model, calib_xs, x_eval, False)
    ref = to_ours(np.asarray(c["out"], np.float32).reshape(c["x_shape"]))
    step = float(np.abs(out).max()) * 0.05 + 0.05
    _close(out, ref, rtol=5e-3, atol=5e-3, step=step, name=case)


@pytest.mark.parametrize("case", ["quantrelu_a8", "quantmaxpool_a8"])
def test_act_layers_replay_the_reference_golden(case):
    c = LAYERS[case]
    cfg = LayerQuantCfg(activation=c["a_setting"])
    if case.startswith("quantrelu"):
        model = QuantReLU(quant=cfg, in_ch=c["x_shape"][1], device="cpu")
    else:
        model = QuantMaxPool((2, 2), (2, 2), ((0, 0), (0, 0)), quant=cfg, in_ch=c["x_shape"][1],
                             device="cpu")
    gen = {"scale": 1.5, "loc": 0.1}
    with torch.no_grad():
        for s in c["calib_seeds"]:
            model(_t(_nhwc(_gen(s, tuple(c["x_shape"]), gen))), mode="calibrate")
        out = _np(model(_t(_nhwc(_gen(c["eval_seed"], tuple(c["x_shape"]), gen))), mode="quant"))
    ref = np.asarray(c["out"], np.float32).reshape(
        (c["x_shape"][0], c["x_shape"][1]) + tuple(out.shape[1:3]))
    _close(out, _nhwc(ref), rtol=1e-4, atol=1e-4, step=float(np.abs(out).max()) * 0.02 + 0.02,
           name=case)


@pytest.mark.parametrize("case", ["adaround_recv", "adaround_reg_b20", "adaround_reg_b2",
                                  "adaround_init_forward"])
def test_adaround_replays_the_reference_golden(case):
    """tests/test_golden_layers.py's AdaRound checks, one case each."""
    if case == "adaround_init_forward":
        c = LAYERS[case]
        x = _t(_gen(c["x_seed"], tuple(c["x_shape"]), c["x_gen"]))
        v = adaround.init_v(x)
        np.testing.assert_allclose(_np(v).reshape(-1), c["v_init"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(adaround.adaround_round(x, v)).reshape(-1), c["out"],
                                   rtol=1e-5, atol=1e-6)
        return
    c = LAYERS["adaround_recv"]
    v = _t(_gen(c["v_seed"], tuple(c["v_shape"]), c["v_gen"]))
    if case == "adaround_recv":
        np.testing.assert_allclose(_np(adaround.rect_sigmoid(v)).reshape(-1), c["out"],
                                   rtol=1e-5, atol=1e-6)
        return
    beta = 20.0 if case == "adaround_reg_b20" else 2.0
    np.testing.assert_allclose(float(adaround.regularization(v, beta)), LAYERS[case]["out"][0],
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# models.json
# ---------------------------------------------------------------------------

def _state_dict(c):
    return {name: gen_param(name, tuple(shape)) for name, shape in c["param_names"]}


def _check_logits(ours, c, which):
    """tests/test_golden_models.py's criteria: fp32 rtol/atol 2e-3; quant
    within the network's own quantization noise (max and mean) and the
    same argmax."""
    ref = np.asarray(c[which], np.float64)
    ours = np.asarray(ours, np.float64).reshape(ref.shape)
    if which == "fp32":
        np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-3,
                                   err_msg=f"{c['case']}: fp32 logits")
        return
    qnoise = np.abs(np.asarray(c["quant"], np.float64) - np.asarray(c["fp32"], np.float64))
    diff = np.abs(ours - ref)
    assert diff.max() <= max(5e-3, float(qnoise.max())), c["case"]
    assert diff.mean() <= max(2e-3, float(qnoise.mean())), c["case"]
    n = len(ref) // c["num_classes"]
    assert np.array_equal(np.argmax(ours.reshape(n, -1), -1), np.argmax(ref.reshape(n, -1), -1))


def _check_qparams(model, c, path_map):
    """Every reference quantizer's calibrated scale/zero (and awq_scale where
    recorded) against the mapped quantizer of the port (rtol 2e-3; atol 1e-7
    scale, 0.05 zero); ``skip_q`` names the 32-bit quantizers the port does
    not create."""
    mine = convert.flatten(convert.to_numpy(model)["qparams"])
    checked = skipped = 0
    for ref_path, rec in c["qparams"].items():
        q = path_map(ref_path)
        # None: a site the mapper excludes (the CLIP attention pool's inert
        # reference quantizers)
        if q is None or (c.get("skip_q") and q.endswith(c["skip_q"])):
            skipped += 1
            continue
        for field in ("scale", "zero") + (("awq_scale",) if "awq_scale" in rec else ()):
            key = f"{q}/{field}"
            assert key in mine, f"{c['case']}: missing qparam {key}"
            ref = np.asarray(rec[field], np.float64)
            ours = np.asarray(mine[key], np.float64).reshape(-1)
            assert ours.shape == ref.shape, f"{c['case']}: {key} {ours.shape} vs {ref.shape}"
            np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=0.05 if field == "zero" else 1e-7,
                                       err_msg=f"{c['case']}: calibrated {key}")
        checked += 1
    assert checked > 0 and checked + skipped == len(c["qparams"])


def _resnet_qpath(ref_path):
    """'layer1.0.conv1.w_quantizer' -> 'layer1_0/conv1/w_quantizer'."""
    parts, out, i = ref_path.split("."), [], 0
    while i < len(parts):
        p = parts[i]
        if p.startswith("layer") and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
        elif p == "downsample" and i + 1 < len(parts) and parts[i + 1] == "0":
            out.append("downsample_conv")
            i += 2
        else:
            out.append(p)
            i += 1
    return "/".join(out)


_RESNETS = ["resnet18_w8a8_bnfold", "resnet18_w8a8_intoscale", "resnet18_w4mse_a8",
            "resnet18_aciq_act8", "resnet18_ce_fc_act8", "resnet18_biascorrect_w8"]


@pytest.mark.parametrize("case", _RESNETS)
def test_resnet18_pipeline_replays_the_reference_golden(case):
    """Built from the quant config, weights imported from the
    torchvision-layout state dict by ``init_model(torch_state_dict=...)``
    (BN folded, into_scale where the config says so, observers reset), then
    calibrated on the fixture's batches."""
    c = MODELS[case]
    cfg = c["quant_cfg"]
    bnf = cfg["default"].get("bn_folding")
    model = qtt.MODELS.build("resnet18", num_classes=c["num_classes"], ctx=qtt.QuantCtx(cfg),
                             device="cpu")
    shape = tuple(c["x_shape"])
    batches = [_nhwc(gen_input(s, shape, c["in_scale"], c["in_loc"])) for s in c["calib_seeds"]]
    x_eval = _t(_nhwc(gen_input(c["eval_seed"], shape, c["in_scale"], c["in_loc"])))
    qtt.init_model(model, batches[0][:1], torch_state_dict=_state_dict(c), model_name="resnet18",
                   fold_bn=bool(bnf), into_scale=isinstance(bnf, dict) and bnf.get("into_scale"),
                   device="cpu")
    qtt.calibrate_model(model, batches, device="cpu")
    _check_qparams(model, c, _resnet_qpath)
    with torch.no_grad():
        _check_logits(_np(model(x_eval, mode="fp32")), c, "fp32")
        _check_logits(_np(model(x_eval, mode="quant")), c, "quant")


class _PreLNBlock(torch.nn.Module):
    def __init__(self, ctx, qpath, d, h, m):
        super().__init__()
        self.ln_1 = FusedLayerNorm(d, epsilon=1e-5, device="cpu")
        self.self_attention = QuantMultiheadAttention(
            d, h, quant=ctx.resolve(f"{qpath}/self_attention", "nn_multiheadattention"),
            device="cpu")
        self.ln_2 = FusedLayerNorm(d, epsilon=1e-5, device="cpu")
        self.linear1 = QuantDense(d, m, quant=ctx.resolve(f"{qpath}/mlp/0", "nn_linear"),
                                  device="cpu")
        self.linear2 = QuantDense(m, d, quant=ctx.resolve(f"{qpath}/mlp/2", "nn_linear"),
                                  device="cpu")

    def forward(self, x, mode="fp32"):
        x = x + self.self_attention(self.ln_1(x, mode), mode=mode)
        y = torch.nn.functional.gelu(self.linear1(self.ln_2(x, mode), mode=mode))
        return x + self.linear2(y, mode=mode)


class _MHAStack(torch.nn.Module):
    """The fixture's two-block pre-LN attention stack (test_golden_models.py)."""

    def __init__(self, ctx, d, h, m, depth, num_classes):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block{i}", _PreLNBlock(ctx, f"/blocks/{i}", d, h, m))
        self.ln = FusedLayerNorm(d, epsilon=1e-5, device="cpu")
        self.head = QuantDense(d, num_classes, quant=ctx.resolve("/head", "nn_linear"),
                               device="cpu")

    def forward(self, x, mode="fp32"):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, mode)
        return self.head(self.ln(x, mode).mean(dim=1), mode=mode)


def _mha_stack_params(c, sd):
    d = c["d"]
    p = {}
    for i in range(c["depth"]):
        pre = f"blocks.{i}."
        iw, ib = sd[pre + "self_attention.in_proj_weight"], sd[pre + "self_attention.in_proj_bias"]
        dense = {"q_proj": (iw[:d], ib[:d]), "k_proj": (iw[d:2 * d], ib[d:2 * d]),
                 "v_proj": (iw[2 * d:], ib[2 * d:]),
                 "out_proj": (sd[pre + "self_attention.out_proj.weight"],
                              sd[pre + "self_attention.out_proj.bias"])}
        for name, (w, b) in dense.items():
            p[f"block{i}/self_attention/{name}/kernel"], p[f"block{i}/self_attention/{name}/bias"] = w.T, b
        for ours, theirs in (("linear1", "mlp.0"), ("linear2", "mlp.2")):
            p[f"block{i}/{ours}/kernel"] = sd[f"{pre}{theirs}.weight"].T
            p[f"block{i}/{ours}/bias"] = sd[f"{pre}{theirs}.bias"]
        for ln in ("ln_1", "ln_2"):
            p[f"block{i}/{ln}/scale"] = sd[f"{pre}{ln}.weight"]
            p[f"block{i}/{ln}/bias"] = sd[f"{pre}{ln}.bias"]
    p["ln/scale"], p["ln/bias"] = sd["ln.weight"], sd["ln.bias"]
    p["head/kernel"], p["head/bias"] = sd["head.weight"].T, sd["head.bias"]
    return convert.unflatten(p)


_MHA_QMAP = {
    "q_quantizer": "self_attention/q_proj/a_quantizer",
    "k_quantizer": "self_attention/k_proj/a_quantizer",
    "v_quantizer": "self_attention/v_proj/a_quantizer",
    "q_proj_quantizer": "self_attention/q_proj/w_quantizer",
    "k_proj_quantizer": "self_attention/k_proj/w_quantizer",
    "v_proj_quantizer": "self_attention/v_proj/w_quantizer",
    "out_proj_quantizer": "self_attention/out_proj/w_quantizer",
}


def _mha_qpath(ref_path):
    parts = ref_path.split(".")
    if parts[0] == "blocks":
        blk = f"block{parts[1]}"
        if parts[2] == "self_attention":
            return f"{blk}/{_MHA_QMAP[parts[-1]]}"
        lin = {"0": "linear1", "2": "linear2"}[parts[3]]
        return f"{blk}/{lin}/{parts[-1]}"
    assert parts[0] == "head", ref_path
    return f"head/{parts[-1]}"


@pytest.mark.parametrize("case", ["mha_stack_w8a8", "mha_stack_w4a8", "mha_stack_biascorrect_w8",
                                  "mha_stack_awq_w4"])
def test_mha_stack_pipeline_replays_the_reference_golden(case):
    c = MODELS[case]
    model = _MHAStack(qtt.QuantCtx(c["quant_cfg"]), c["d"], c["h"], c["m"], c["depth"],
                      c["num_classes"])
    convert.from_jax_variables(model, {"params": _mha_stack_params(c, _state_dict(c))})
    shape = tuple(c["x_shape"])  # (S, B, E): seq-first in the reference
    batches = [_t(np.transpose(gen_input(s, shape), (1, 0, 2))) for s in c["calib_seeds"]]
    x_eval = _t(np.transpose(gen_input(c["eval_seed"], shape), (1, 0, 2)))
    with torch.no_grad():
        for xb in batches:
            model(xb, mode="calibrate")
        _check_qparams(model, c, _mha_qpath)
        _check_logits(_np(model(x_eval, mode="fp32")), c, "fp32")
        _check_logits(_np(model(x_eval, mode="quant")), c, "quant")


# the MobileNet-style stack of test_golden_models.py: (name, in, expanded,
# out, stride) for its two inverted-residual blocks
_MOBILE_BLOCKS = (("block1", 8, 32, 8, 1), ("block2", 8, 32, 16, 2))


class _MobileStack(torch.nn.Module):
    def __init__(self, ctx, num_classes):
        super().__init__()

        def conv(qpath, cin, feats, k, s, pad, groups=1):
            return QuantConv(cin, feats, (k, k), (s, s), padding=pad, feature_group_count=groups,
                             quant=ctx.resolve(qpath, "nn_conv2d"), device="cpu")

        self.stem_conv = conv("/stem_conv", 3, 8, 3, 2, [(1, 1), (1, 1)])
        for bname, cin, cexp, cout, s in _MOBILE_BLOCKS:
            setattr(self, f"{bname}_expand_conv",
                    conv(f"/{bname}/expand_conv", cin, cexp, 1, 1, "VALID"))
            setattr(self, f"{bname}_dw_conv",
                    conv(f"/{bname}/dw_conv", cexp, cexp, 3, s, [(1, 1), (1, 1)], groups=cexp))
            setattr(self, f"{bname}_project_conv",
                    conv(f"/{bname}/project_conv", cexp, cout, 1, 1, "VALID"))
        self.fc = QuantDense(16, num_classes, quant=ctx.resolve("/fc", "nn_linear"), device="cpu")

    def forward(self, x, mode="fp32"):
        relu6 = lambda v: torch.clamp(v, 0.0, 6.0)  # noqa: E731
        x = relu6(self.stem_conv(x, mode=mode))
        for bname, cin, _, cout, s in _MOBILE_BLOCKS:
            y = relu6(getattr(self, f"{bname}_expand_conv")(x, mode=mode))
            y = relu6(getattr(self, f"{bname}_dw_conv")(y, mode=mode))
            y = getattr(self, f"{bname}_project_conv")(y, mode=mode)
            x = x + y if (s == 1 and cin == cout) else y
        return self.fc(x.mean(dim=(1, 2)), mode=mode)


def _mobile_params(sd):
    """BN folded as the reference's conv2d_bn2d feeds QuantConv2d (no conv
    bias: bias = beta - mean * gamma / sqrt(var + eps))."""
    p = {}
    for ours, conv, bn in [("stem_conv", "stem_conv", "stem_bn")] + [
            (f"{b}_{part}_conv", f"{b}.{part}_conv", f"{b}.{part}_bn")
            for b, *_ in _MOBILE_BLOCKS for part in ("expand", "dw", "project")]:
        mult = sd[f"{bn}.weight"] / np.sqrt(sd[f"{bn}.running_var"] + 1e-5)
        p[f"{ours}/kernel"] = (sd[f"{conv}.weight"] * mult.reshape(-1, 1, 1, 1)).transpose(2, 3, 1, 0)
        p[f"{ours}/bias"] = sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * mult
    p["fc/kernel"], p["fc/bias"] = sd["fc.weight"].T, sd["fc.bias"]
    return convert.unflatten(p)


def _mobile_qpath(ref_path):
    """'block1.dw_conv.a_quantizer' -> 'block1_dw_conv/a_quantizer'."""
    parts = ref_path.split(".")
    if parts[0] in ("stem_conv", "fc"):
        return "/".join(parts)
    return f"{parts[0]}_{parts[1]}/{parts[2]}"


def test_mobile_stack_pipeline_replays_the_reference_golden():
    c = MODELS["mobile_stack_w8a8"]
    model = _MobileStack(qtt.QuantCtx(c["quant_cfg"]), c["num_classes"])
    convert.from_jax_variables(model, {"params": _mobile_params(_state_dict(c))})
    shape = tuple(c["x_shape"])
    batches = [_t(_nhwc(gen_input(s, shape, c["in_scale"], c["in_loc"])))
               for s in c["calib_seeds"]]
    x_eval = _t(_nhwc(gen_input(c["eval_seed"], shape, c["in_scale"], c["in_loc"])))
    with torch.no_grad():
        for xb in batches:
            model(xb, mode="calibrate")
        _check_qparams(model, c, _mobile_qpath)
        _check_logits(_np(model(x_eval, mode="fp32")), c, "fp32")
        _check_logits(_np(model(x_eval, mode="quant")), c, "quant")


# the reference's own CLIP towers (tests/test_golden_models.py)

def _clip_vit_params(c, sd):
    d, p = c["width"], {}
    p["conv1/kernel"] = sd["conv1.weight"].transpose(2, 3, 1, 0)
    for name in ("class_embedding", "positional_embedding", "proj"):
        p[name] = sd[name]
    for ln in ("ln_pre", "ln_post"):
        p[f"{ln}/scale"], p[f"{ln}/bias"] = sd[f"{ln}.weight"], sd[f"{ln}.bias"]
    for i in range(c["layers"]):
        pre, blk = f"transformer.resblocks.{i}.", f"transformer/resblock_{i}"
        iw, ib = sd[pre + "attn.in_proj_weight"], sd[pre + "attn.in_proj_bias"]
        dense = {"attn/q_proj": (iw[:d], ib[:d]), "attn/k_proj": (iw[d:2 * d], ib[d:2 * d]),
                 "attn/v_proj": (iw[2 * d:], ib[2 * d:]),
                 "attn/out_proj": (sd[pre + "attn.out_proj.weight"],
                                   sd[pre + "attn.out_proj.bias"]),
                 "c_fc": (sd[pre + "mlp.c_fc.weight"], sd[pre + "mlp.c_fc.bias"]),
                 "c_proj": (sd[pre + "mlp.c_proj.weight"], sd[pre + "mlp.c_proj.bias"])}
        for name, (w, b) in dense.items():
            p[f"{blk}/{name}/kernel"], p[f"{blk}/{name}/bias"] = w.T, b
        for ln in ("ln_1", "ln_2"):
            p[f"{blk}/{ln}/scale"] = sd[f"{pre}{ln}.weight"]
            p[f"{blk}/{ln}/bias"] = sd[f"{pre}{ln}.bias"]
    return convert.unflatten(p)


def _clip_vit_qpath(ref_path):
    parts = ref_path.split(".")
    if parts[0] == "conv1":
        return f"conv1/{parts[-1]}"
    blk = f"transformer/resblock_{parts[2]}"
    if parts[3] == "attn":
        return f"{blk}/{_MHA_QMAP[parts[-1]].replace('self_attention', 'attn')}"
    assert parts[3] == "mlp", ref_path  # mlp.c_fc / mlp.c_proj sit flat in the block
    return f"{blk}/{parts[4]}/{parts[-1]}"


def _clip_rn_params(c, sd):
    p = {}

    def conv_fold(ours, conv, bn):
        w, b, _ = fold_bn(sd[f"{conv}.weight"], None, sd[f"{bn}.weight"], sd[f"{bn}.bias"],
                          sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"])
        p[f"{ours}/kernel"], p[f"{ours}/bias"] = w.transpose(2, 3, 1, 0), b

    for i in (1, 2, 3):
        conv_fold(f"conv{i}", f"conv{i}", f"bn{i}")
    for stage in (1, 2, 3, 4):
        pre = f"layer{stage}.0."
        for i in (1, 2, 3):
            conv_fold(f"layer{stage}_0/conv{i}", pre + f"conv{i}", pre + f"bn{i}")
        if f"{pre}downsample.0.weight" in sd:
            conv_fold(f"layer{stage}_0/downsample_conv", pre + "downsample.0", pre + "downsample.1")
    p["attnpool/positional_embedding"] = sd["attnpool.positional_embedding"]
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        p[f"attnpool/{proj}/kernel"] = sd[f"attnpool.{proj}.weight"].T
        p[f"attnpool/{proj}/bias"] = sd[f"attnpool.{proj}.bias"]
    return convert.unflatten(p)


def _clip_rn_qpath(ref_path):
    parts = ref_path.split(".")
    if parts[0].startswith("layer"):
        blk = f"{parts[0]}_{parts[1]}"
        conv = "downsample_conv" if parts[2] == "downsample" else parts[2]
        return f"{blk}/{conv}/{parts[-1]}"
    if parts[0].startswith("conv"):
        return f"{parts[0]}/{parts[-1]}"
    assert parts[0] == "attnpool", ref_path
    return None  # inert in the reference (never calibrated): skipped, as in JAX's replay


@pytest.mark.parametrize("case", ["clip_vit_tower_w8a8", "clip_rn_tower_w8a8"])
def test_clip_tower_replays_the_reference_golden(case):
    """The reference's own CLIP VisionTransformer and ModifiedResNet towers
    (tests/test_golden_models.py), the port's towers built from the quant
    config, the state dict carried in (BN folded for the RN tower), then
    calibrated on the fixture's batches."""
    c = MODELS[case]
    ctx = qtt.QuantCtx(c["quant_cfg"])
    shape = tuple(c["x_shape"])
    if c["kind"] == "clip_vit":
        model = CLIPVisionTransformer(c["patch"], c["width"], c["layers"], c["heads"], c["out_dim"],
                                      image_size=shape[2], ctx=ctx, device="cpu")
        params, qpath = _clip_vit_params(c, _state_dict(c)), _clip_vit_qpath
    else:
        model = ModifiedResNet(tuple(c["layers"]), c["out_dim"], c["heads"], c["width"],
                               image_size=shape[2], ctx=ctx, device="cpu")
        params, qpath = _clip_rn_params(c, _state_dict(c)), _clip_rn_qpath
    convert.from_jax_variables(model, {"params": params})
    batches = [_t(_nhwc(gen_input(s, shape, c["in_scale"], c["in_loc"])))
               for s in c["calib_seeds"]]
    x_eval = _t(_nhwc(gen_input(c["eval_seed"], shape, c["in_scale"], c["in_loc"])))
    with torch.no_grad():
        for xb in batches:
            model(xb, mode="calibrate")
        _check_qparams(model, c, qpath)
        _check_logits(_np(model(x_eval, mode="fp32")), c, "fp32")
        _check_logits(_np(model(x_eval, mode="quant")), c, "quant")
