"""Parity of the port's quantization core (quantize_tpu_torch.quant) with the
JAX package: grids, scale/zero, fake-quant and the observers (MinMax,
MAMinMax and MSE, also replayed against tests/golden/observers.json, as
tests/test_torch_golden.py replays every observer case; CrossEntropy, ACIQ
and AWQ step by step).

Inputs are made with numpy from a seed and fed to both packages. Unless a
test says otherwise, results must be bit-equal: the port runs the same
float32 operations in the same order.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.ops.pallas.qmatmul import quantize_act_int8 as jax_quantize_act
from quantize_tpu.quant import fakequant as jfq
from quantize_tpu.quant import qspec as jqs
from quantize_tpu.quant.observers import MSE as JMSE
from quantize_tpu.quant.observers import MAMinMax as JMAMinMax
from quantize_tpu.quant.observers import MinMax as JMinMax
from quantize_tpu_torch.ops.qmatmul import quantize_act_int8
from quantize_tpu_torch.quant import fakequant as tfq
from quantize_tpu_torch.quant import qspec as tqs
from quantize_tpu_torch.quant.observers import MSE, MAMinMax, MinMax, build_observer

torch.set_num_threads(2)

GRIDS = [(8, True, True), (8, False, True), (8, True, False), (4, True, True), (16, False, False)]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("n_bits,symmetric,signed", GRIDS)
def test_qrange_and_scale_zero(n_bits, symmetric, signed):
    assert tqs.qrange(n_bits, symmetric, signed) == jqs.qrange(n_bits, symmetric, signed)
    rng = np.random.default_rng(n_bits)
    xmin = rng.uniform(-3, 0, size=(7,)).astype(np.float32)
    xmax = rng.uniform(0, 3, size=(7,)).astype(np.float32)
    xmax[0] = xmin[0] = 0.0  # zero range -> eps scale
    s_j, z_j = jqs.compute_scale_zero(jnp.asarray(xmin), jnp.asarray(xmax), n_bits, symmetric, signed)
    s_t, z_t = tqs.compute_scale_zero(torch.from_numpy(xmin), torch.from_numpy(xmax),
                                      n_bits, symmetric, signed)
    np.testing.assert_array_equal(_np(s_t), np.asarray(s_j))
    np.testing.assert_array_equal(_np(z_t), np.asarray(z_j))


def test_quantspec_fields_match():
    cfg = {"n_bits": 8, "symmetric": False, "granularity": "c",
           "range": {"name": "minmax", "percentile": 0.01}, "static_scale": 2.0}
    sj = jqs.QuantSpec.from_config(cfg, "activation")
    st = tqs.QuantSpec.from_config(cfg, "activation")
    for attr in ("n_bits", "symmetric", "signed", "granularity", "qmin", "qmax", "enabled",
                 "range_name", "per_channel", "flag", "channel_axis"):
        assert getattr(st, attr) == getattr(sj, attr), attr
    assert st.range_kwargs == sj.range_kwargs
    assert st.n_channels((2, 3, 5)) == sj.n_channels((2, 3, 5)) == 5


@pytest.mark.parametrize("shape,axis", [((5,), 0), ((2, 3, 4, 5), -1), ((1,), 2)])
def test_broadcast_to_axis(shape, axis):
    v = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    if len(shape) > 1:
        v = v.reshape(-1)[:shape[-1]]
    bj = jqs.broadcast_to_axis(jnp.asarray(v), 4, axis)
    bt = tqs.broadcast_to_axis(torch.from_numpy(v), 4, axis)
    assert tuple(bt.shape) == tuple(bj.shape)


@pytest.mark.parametrize("qmin,qmax", [(-128, 127), (0, 255)])
def test_fake_quant_half_to_even_ties(qmin, qmax):
    # exact half-integer grid positions: round half to even must agree
    scale = np.float32(0.5)
    zero = np.float32(-3.0 if qmin == 0 else 0.0)
    halves = (np.arange(-300, 300, dtype=np.float32) + 0.5) * scale
    x = np.concatenate([halves, np.random.default_rng(0).normal(scale=20, size=500).astype(np.float32)])
    qj = jfq.quantize_core(jnp.asarray(x), jnp.asarray([scale]), jnp.asarray([zero]), qmin, qmax)
    qt = tfq.quantize_core(torch.from_numpy(x), torch.tensor([scale]), torch.tensor([zero]),
                           qmin, qmax)
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))
    assert np.any(np.asarray(qj)[:600] % 2 == 0)  # ties really were exercised
    fj = jfq.fake_quant(jnp.asarray(x), jnp.asarray([scale]), jnp.asarray([zero]), qmin, qmax)
    ft = tfq.fake_quant(torch.from_numpy(x), torch.tensor([scale]), torch.tensor([zero]), qmin, qmax)
    np.testing.assert_array_equal(_np(ft), np.asarray(fj))


def test_fake_quant_per_channel_with_static_scale():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    s = rng.uniform(0.01, 0.05, size=(6,)).astype(np.float32)
    z = rng.uniform(-2, 2, size=(6,)).astype(np.float32)
    ss = rng.uniform(0.5, 2, size=(6,)).astype(np.float32)
    fj = jfq.fake_quant(jnp.asarray(x), jnp.asarray(s), jnp.asarray(z), -128, 127,
                        channel_axis=-1, static_scale=jnp.asarray(ss))
    ft = tfq.fake_quant(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(z), -128, 127,
                        channel_axis=-1, static_scale=torch.from_numpy(ss))
    np.testing.assert_array_equal(_np(ft), np.asarray(fj))


def test_ste_gradient_is_identity_inside_and_at_the_clamp_edges():
    # the JAX STE passes gradient 1 inside [qmin, qmax] inclusive, 0 outside
    x = torch.tensor([-300.0, -128.0, -3.2, 0.0, 4.5, 127.0, 300.0], requires_grad=True)
    q = tfq.quantize_core(x, torch.tensor([1.0]), torch.tensor([0.0]), -128, 127)
    q.sum().backward()
    np.testing.assert_array_equal(_np(x.grad), [0, 1, 1, 1, 1, 1, 0])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("qmin,qmax", [(0, 255), (-128, 127)])
def test_quantize_act_int8_unsigned_shift(qmin, qmax, dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(scale=3, size=(4, 33)).astype(np.float32)
    x[0, :5] = (np.arange(5) + 0.5) * 0.05 + 0.05 * -12.0  # exact ties at the grid
    scale, zero = np.float32(0.05), np.float32(-12.0 if qmin == 0 else 0.0)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":  # bf16 carries are read back in f32 by both
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    qj, zj = jax_quantize_act(xj, scale, zero, qmin, qmax)
    qt, zt = quantize_act_int8(xt, torch.tensor(scale), torch.tensor(zero), qmin, qmax)
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))
    assert float(zt) == float(zj) == float(zero) + (128.0 if qmin >= 0 else 0.0)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("granularity", ["layer", "channel"])
@pytest.mark.parametrize("percentile", [0.0, 0.01])
def test_minmax_observer_accumulates_like_jax(symmetric, granularity, percentile):
    cfg = {"n_bits": 8, "symmetric": symmetric, "granularity": granularity,
           "range": {"name": "minmax", "percentile": percentile}}
    sj = jqs.QuantSpec.from_config(cfg, "activation")
    st = tqs.QuantSpec.from_config(cfg, "activation")
    oj, ot = JMinMax(sj, percentile=percentile), build_observer(st)
    assert isinstance(ot, MinMax)
    c = 5 if granularity == "channel" else 1
    state_j, state_t = oj.init_state(c), ot.init_state(c)
    rng = np.random.default_rng(3)
    for step in range(3):
        x = rng.normal(loc=step - 1, scale=1 + step, size=(4, 6, 6, 5)).astype(np.float32)
        state_j, s_j, z_j = oj(state_j, jnp.asarray(x))
        state_t, s_t, z_t = ot(state_t, torch.from_numpy(x))
        for key in ("xmin", "xmax", "count"):
            np.testing.assert_array_equal(_np(state_t[key]), np.asarray(state_j[key]))
        np.testing.assert_array_equal(_np(s_t), np.asarray(s_j))
        np.testing.assert_array_equal(_np(z_t), np.asarray(z_j))


@pytest.mark.parametrize("name,flag,granularity,kwargs", [
    ("cross_entropy", "activation", "layer", {"grid": 40}),
    ("aciq", "activation", "layer", {}),
    ("aciq", "activation", "channel", {"fuse_relu": True}),
    ("awq", "weight", "channel", {"grid": 8}),
    ("awq", "weight", "channel", {"grid": 8, "q_group_size": 8, "accumulate": False})])
def test_ce_aciq_and_awq_observers_follow_jax_step_by_step(name, flag, granularity, kwargs):
    """build_observer gives the port's CrossEntropy, ACIQ and AWQ; three
    calibration steps through both packages' observers agree: state,
    scale/zero (and AWQ's awq_scale) rtol 1e-5 (float32 sums in another
    order; seen: equal or within a few ulps)."""
    from quantize_tpu.quant.observers import build_observer as jax_build_observer

    cfg = {"n_bits": 4 if name == "awq" else 8, "symmetric": name == "awq",
           "signed": name == "awq", "granularity": granularity, "range": {"name": name, **kwargs}}
    sj = jqs.QuantSpec.from_config(cfg, flag)
    st = tqs.QuantSpec.from_config(cfg, flag)
    oj, ot = jax_build_observer(sj), build_observer(st)
    assert type(ot).__name__ == type(oj).__name__
    rng = np.random.default_rng(len(name) + len(kwargs))
    w = rng.normal(scale=0.4, size=(32, 6)).astype(np.float32)  # (in, out)
    apply_fn = lambda wm, a: a @ wm  # noqa: E731
    n = 32 if name == "awq" else (5 if granularity == "channel" else 1)
    state_j, state_t = oj.init_state(n), ot.init_state(n)
    for step in range(3):
        x = rng.normal(loc=step - 1, scale=1 + step, size=(4, 6, 6, 5)).astype(np.float32)
        if name == "awq":
            a = np.abs(rng.normal(size=(8, 32))).astype(np.float32) * (1 + step)
            state_j, s_j, z_j, aws_j = oj(state_j, jnp.asarray(w), pre_act=jnp.asarray(a),
                                          apply_fn=apply_fn)
            state_t, s_t, z_t, aws_t = ot(state_t, torch.from_numpy(w),
                                          pre_act=torch.from_numpy(a), apply_fn=apply_fn)
            np.testing.assert_allclose(_np(aws_t), np.asarray(aws_j), rtol=1e-5)
        else:
            state_j, s_j, z_j = oj(state_j, jnp.asarray(x))
            state_t, s_t, z_t = ot(state_t, torch.from_numpy(x))
        assert set(state_t) == set(state_j)
        for key in state_j:
            np.testing.assert_allclose(_np(state_t[key]), np.asarray(state_j[key]), rtol=1e-5)
        np.testing.assert_allclose(_np(s_t), np.asarray(s_j), rtol=1e-5)
        np.testing.assert_allclose(_np(z_t), np.asarray(z_j), rtol=1e-5, atol=1e-5)


_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "observers.json")
with open(_GOLDEN) as _f:
    _GOLDEN_CASES = {c["case"]: c for c in json.load(_f)["cases"]}


@pytest.mark.parametrize("case", [k for k, c in _GOLDEN_CASES.items()
                                  if c["cfg"].get("name") in ("maminmax", "mse")])
def test_observer_replays_the_reference_golden(case):
    """The reference library's own range estimators on seeded tensors, fed
    through the port's build_observer, within the tolerances of
    tests/test_golden_parity.py (scale rtol 1e-4 / atol 1e-6, zero rtol 1e-4
    / atol 1e-4). Fixture layout: weights channel axis 0, activations 1."""
    c = _GOLDEN_CASES[case]
    cfg = dict(c["cfg"])
    name = cfg.pop("name")
    axis = 0 if c["flag"] == "weight" else 1
    kwargs = {k: v for k, v in cfg.items() if k in ("percentile", "momentum", "grid",
                                                   "maxshrink", "norm")}
    spec = tqs.QuantSpec.from_config({**cfg, "range": {"name": name, **kwargs}}, c["flag"],
                                     channel_axis=axis)
    obs = build_observer(spec)
    assert isinstance(obs, {"maminmax": MAMinMax, "mse": MSE}[name])
    state = obs.init_state(c["shape"][axis] if spec.per_channel else 1)
    for seed in c["seeds"]:
        x = (np.random.default_rng(seed).normal(size=tuple(c["shape"])) * c["gen"].get("scale", 1.0)
             + c["gen"].get("loc", 0.0)).astype(np.float32)
        state, scale, zero = obs(state, torch.from_numpy(x))
    np.testing.assert_allclose(_np(scale).reshape(-1), c["scale"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(zero).reshape(-1), c["zero"], rtol=1e-4, atol=1e-4)
    assert (spec.qmin, spec.qmax) == (c["qmin"], c["qmax"])


@pytest.mark.parametrize("name,granularity,symmetric,n_bits", [
    ("maminmax", "layer", False, 8), ("maminmax", "channel", True, 8),
    ("mse", "channel", True, 4), ("mse", "layer", False, 8)])
def test_maminmax_and_mse_follow_jax_step_by_step(name, granularity, symmetric, n_bits):
    """Three calibration steps through both packages' observers. State and
    scale/zero agree to float32 reassociation: the MSE error sums run in
    another order, which could only move a shrink decision between two
    grid points whose errors tie to ~1e-7 (rtol 1e-6 holds; seen: equal)."""
    cfg = {"n_bits": n_bits, "symmetric": symmetric, "granularity": granularity,
           "range": {"name": name, "momentum": 0.3} if name == "maminmax" else {"name": name}}
    sj = jqs.QuantSpec.from_config(cfg, "weight")
    st = tqs.QuantSpec.from_config(cfg, "weight")
    jcls = {"maminmax": JMAMinMax, "mse": JMSE}[name]
    oj, ot = jcls(sj, **sj.range_kwargs), build_observer(st)
    c = 6 if granularity == "channel" else 1
    state_j, state_t = oj.init_state(c), ot.init_state(c)
    rng = np.random.default_rng(11)
    for step in range(3):
        x = rng.normal(loc=0.2 * step, scale=1 + step, size=(40, 6)).astype(np.float32)
        x[step, 0] = 9.0  # an outlier the MSE search shrinks away
        state_j, s_j, z_j = oj(state_j, jnp.asarray(x))
        state_t, s_t, z_t = ot(state_t, torch.from_numpy(x))
        for key in ("xmin", "xmax", "count"):
            np.testing.assert_allclose(_np(state_t[key]), np.asarray(state_j[key]), rtol=1e-6)
        np.testing.assert_allclose(_np(s_t), np.asarray(s_j), rtol=1e-6)
        np.testing.assert_allclose(_np(z_t), np.asarray(z_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_bits,symmetric,signed", [(8, True, True), (8, False, False),
                                                     (4, True, True), (12, True, True)])
def test_quantize_int_matches_jax(n_bits, symmetric, signed):
    """The deploy path's integer quantize (``quant.fakequant.quantize_int``)
    and ``QuantSpec.storage_dtype``, per channel, against JAX's."""
    cfg = {"n_bits": n_bits, "symmetric": symmetric, "signed": signed, "granularity": "channel"}
    sj, st = jqs.QuantSpec.from_config(cfg, "weight"), tqs.QuantSpec.from_config(cfg, "weight")
    rng = np.random.default_rng(n_bits)
    x = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    s = rng.uniform(0.002, 0.05, size=(6,)).astype(np.float32)
    z = rng.integers(-3, 3, size=(6,)).astype(np.float32)
    qj = jfq.quantize_int(jnp.asarray(x), jnp.asarray(s), jnp.asarray(z), sj)
    qt = tfq.quantize_int(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(z), st)
    assert str(qt.dtype).replace("torch.", "") == np.dtype(sj.storage_dtype).name
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))


@pytest.mark.parametrize("static", [False, True])
def test_quantize_with_qparams_matches_jax(static):
    """``nn.quantizer.quantize_with_qparams``: the integers, the effective
    scale (``static_scale`` folded in) and the zero, as JAX's."""
    from quantize_tpu.nn.quantizer import quantize_with_qparams as jax_qwq
    from quantize_tpu_torch.nn.quantizer import quantize_with_qparams

    cfg = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel"}
    sj, st = jqs.QuantSpec.from_config(cfg, "weight"), tqs.QuantSpec.from_config(cfg, "weight")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    qp = {"scale": rng.uniform(0.005, 0.03, size=(6,)).astype(np.float32),
          "zero": np.zeros((6,), np.float32)}
    if static:
        qp["static_scale"] = rng.uniform(0.5, 2.0, size=(6,)).astype(np.float32)
    want = jax_qwq(jnp.asarray(x), sj, {k: jnp.asarray(v) for k, v in qp.items()})
    got = quantize_with_qparams(torch.from_numpy(x), st,
                                {k: torch.from_numpy(v) for k, v in qp.items()})
    assert got[0].dtype == torch.int8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
