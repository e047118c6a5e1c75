"""One model through the JAX package and the port on the CPU, for the
model-level parity tests (``tests/test_torch_mobilenet*.py``,
``tests/test_torch_wideresnet.py``, and under the int8 carry
``tests/test_torch_qin_carry*.py``).

Both packages start from the same variables (JAX's init, carried over with
``quantize_tpu_torch.convert``), calibrate on the same batch, pack from the
same calibrated variables and serve the same input. JAX's init, calibrate
and float/quant forwards run under ``jit`` (their outputs are compared at
float32-reassociation tolerances), and so does its ``deploy.pack_model``
(the integer buffers are what its eager pack gives: the quantize divides,
as eager JAX does; the port's buffers are held to them bit for bit). Its
packed forward runs eagerly, the float32 operations the port repeats in
the same order, or where ``eager_packed`` is false under ``jit``, whose
epilogues XLA contracts into FMAs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.ops import launch_counts


def run_both(name, cfg, x, x_cal, kw=None, batch_stats=None, eager_packed=True):
    """``name`` (a registry name, or a pair of constructors ``(jax_cls,
    port_cls)`` taking ``num_classes``, ``ctx`` and ``kw``) built from
    ``cfg`` (constructor keywords ``kw``) in both packages: a dict of paired
    results (port, JAX). ``batch_stats`` maps a JAX ``batch_stats`` tree to
    the one both packages use (live BatchNorms)."""
    kw = kw or {}
    if isinstance(name, str):
        jax_cls, port_cls = (lambda **a: JAX_MODELS.build(name, **a),
                             lambda **a: qtt.MODELS.build(name, **a))
    else:
        jax_cls, port_cls = name
    xj = jnp.asarray(x)
    jm = jax_cls(num_classes=10, ctx=JaxQuantCtx(cfg), **kw)
    v0 = dict(jax.jit(lambda k, a: jm.init(k, a, mode="calibrate"))(jax.random.PRNGKey(0), xj))
    v0.pop("taps", None)
    v0 = jax.device_get(v0)
    if batch_stats is not None:
        v0["batch_stats"] = batch_stats(v0["batch_stats"])
    _, upd = jax.jit(lambda v, a: jm.apply(v, a, mode="calibrate", mutable=["qobs", "qparams"]))(
        v0, jnp.asarray(x_cal))
    v1 = jax.device_get({**v0, **upd})
    tm = port_cls(num_classes=10, ctx=qtt.QuantCtx(cfg), device="cpu", **kw)
    convert.from_jax_variables(tm, v0)
    qtt.calibrate_model(tm, [x_cal], device="cpu")
    out = {"calibrated": (convert.to_numpy(tm), v1)}
    convert.from_jax_variables(tm, v1)
    jfwd = jax.jit(lambda v, a, mode: jm.apply(v, a, mode=mode), static_argnums=2)
    with torch.no_grad():
        for mode in ("fp32", "quant"):
            out[mode] = (tm(torch.from_numpy(x), mode=mode).numpy(),
                         np.asarray(jfwd(v1, xj, mode)))
    out["noise"] = np.abs(out["quant"][1] - out["fp32"][1])
    deploy = jax.device_get(jax.jit(lambda v, a: jax_pack_model(jm, v, a))(v1, xj))
    port_deploy = qtt.pack_model(tm, x, device="cpu")
    out["packed_buffers"] = (convert.flatten(convert.to_numpy(tm)["packed"]),
                             convert.flatten(deploy["packed"]))
    out["deploy_keys"] = ({c: set(v) for c, v in port_deploy.items()},
                          {c: set(convert.flatten(v)) for c, v in deploy.items()})
    fresh = port_cls(num_classes=10, ctx=qtt.QuantCtx(cfg), device="cpu", **kw)
    convert.from_jax_variables(fresh, deploy)
    before = launch_counts()
    with torch.no_grad():
        got = [m(torch.from_numpy(x), mode="packed").numpy() for m in (tm, fresh)]
    if eager_packed:
        want = np.asarray(jm.apply(deploy, xj, mode="packed"))
    else:
        want = np.asarray(jfwd(deploy, xj, "packed"))
    out["packed"] = (got, want)
    out["launches_unchanged"] = launch_counts() == before
    return out


def check_calibrated(out, rtol=1e-5):
    """Calibrated qparams and observer state: float32 reassociation of the
    calibrate pass's convolutions (oneDNN against XLA)."""
    port, theirs = out["calibrated"]
    for col in ("qparams", "qobs"):
        mine, want = convert.flatten(port.get(col, {})), convert.flatten(theirs.get(col, {}))
        assert set(mine) == set(want), col
        for key, val in want.items():
            if key.endswith("count"):
                np.testing.assert_array_equal(mine[key], val, err_msg=key)
            else:
                np.testing.assert_allclose(mine[key], val, rtol=rtol, atol=1e-7, err_msg=key)


def check_fp32_and_quant(out):
    """fp32 logits at float32-reassociation tolerance (rtol/atol 1e-4, as
    the ResNet tests); quant logits within the network's own quantization
    noise (a float32 difference near a round() boundary flips a step) with
    the same argmax."""
    got, want = out["fp32"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    got, want = out["quant"]
    noise = out["noise"]
    assert np.max(np.abs(got - want)) <= max(noise.max(), 1e-6 * np.abs(want).max())
    assert np.mean(np.abs(got - want)) <= max(noise.mean(), 1e-6 * np.abs(want).max())
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def check_packed(out, logits="exact", exact=("w_int", "w_p4c", "w_p4", "corr_a", "col_sum")):
    """Pack buffers bit-equal (integers and the correction maps; scales at
    rtol 1e-6), the deploy layout JAX's, and the packed logits from the
    port's pack and from JAX's deploy variables equal to each other and,
    by ``logits``: ``"exact"``, bit-equal to eager JAX's; ``"float"``
    (every conv a float32 library conv: weight-only), within float32
    reassociation, rtol 1e-5; ``"noise"`` (against jitted JAX), within the
    network's quantization noise with the same argmax, as quant mode."""
    mine, theirs = out["packed_buffers"]
    assert set(mine) == set(theirs)
    for key, val in theirs.items():
        assert mine[key].dtype == np.asarray(val).dtype, key
        if key.endswith(exact):
            np.testing.assert_array_equal(mine[key], val, err_msg=key)
        else:
            np.testing.assert_allclose(mine[key], val, rtol=1e-6, atol=0, err_msg=key)
    assert out["deploy_keys"][0] == out["deploy_keys"][1]
    got, want = out["packed"]
    np.testing.assert_array_equal(got[0], got[1])
    if logits == "exact":
        np.testing.assert_array_equal(got[0], want)
    elif logits == "float":
        np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        noise = out["noise"]
        assert np.max(np.abs(got[0] - want)) <= max(noise.max(), 1e-6 * np.abs(want).max())
        assert np.array_equal(got[0].argmax(-1), want.argmax(-1))
    assert out["launches_unchanged"]


CARRIES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def run_carry(jax_ctor, port_ctor, cfg, x, x_cal, jit_packed=False, fused_opts=(False,)):
    """The packed forward of one model under the int8 carry (``qin_carry``)
    in both packages, from the same calibrated variables (JAX's init,
    calibrate and pack under ``jit``; its packed forward eager, or under
    ``jit`` where ``jit_packed``), at f32 and bf16 carry and each fused-tail
    setting: ``{("carry", carry, fused): (port, JAX)}``, float32 numpy
    logits, with ``("grouped", carry, fused)``: the port's calls of K3g's
    wrapper in that forward; ``fp32``/``quant``: JAX's logits;
    ``no_carry``: the port's packed logits without the carry; ``quant_flag``:
    the port's quant-mode logits with the flag on and off."""
    from quantize_tpu.nn.precision import fused_residual as jax_fused_residual
    from quantize_tpu.nn.precision import packed_carry as jax_packed_carry
    from quantize_tpu.nn.precision import qin_carry as jax_qin_carry
    import quantize_tpu_torch.ops.qconv as port_qconv

    xj = jnp.asarray(x)
    jm = jax_ctor(num_classes=10, ctx=JaxQuantCtx(cfg))
    v0 = dict(jax.jit(lambda k, a: jm.init(k, a, mode="calibrate"))(jax.random.PRNGKey(0), xj))
    v0.pop("taps", None)
    _, upd = jax.jit(lambda v, a: jm.apply(v, a, mode="calibrate", mutable=["qobs", "qparams"]))(
        v0, jnp.asarray(x_cal))
    v1 = jax.device_get({**v0, **upd})
    deploy = jax.device_get(jax.jit(lambda v, a: jax_pack_model(jm, v, a))(v1, xj))
    tm = port_ctor(num_classes=10, ctx=qtt.QuantCtx(cfg), device="cpu")
    convert.from_jax_variables(tm, v1)
    convert.from_jax_variables(tm, deploy)
    out = {mode: np.asarray(jax.jit(lambda v, a: jm.apply(v, a, mode=mode))(v1, xj))
           for mode in ("fp32", "quant")}
    grouped, calls = port_qconv.qconv2d_grouped_int8, []

    def counting(*args):
        calls.append(args[0].shape)
        return grouped(*args)

    xt = torch.from_numpy(x)
    with torch.no_grad():
        for carry, (jdt, tdt) in CARRIES.items():
            for fused in fused_opts:
                with jax_qin_carry(True), jax_packed_carry(jdt), jax_fused_residual(fused):
                    if jit_packed:
                        want = jax.jit(lambda v, a: jm.apply(v, a, mode="packed"))(deploy, xj)
                    else:
                        want = jm.apply(deploy, xj, mode="packed")
                port_qconv.qconv2d_grouped_int8 = counting
                try:
                    with qtt.qin_carry(True), qtt.packed_carry(tdt), qtt.fused_residual(fused):
                        got = tm(xt, mode="packed")
                finally:
                    port_qconv.qconv2d_grouped_int8 = grouped
                out[("carry", carry, fused)] = (got.float().numpy(), np.asarray(want, np.float32))
                out[("grouped", carry, fused)] = len(calls)
                calls.clear()
        out["no_carry"] = tm(xt, mode="packed").numpy()
        quant = tm(xt, mode="quant").numpy()
        with qtt.qin_carry(True):
            out["quant_flag"] = (tm(xt, mode="quant").numpy(), quant)
    return out


def check_carry(out, carry, fused, logits):
    """The port's packed logits under the carry against JAX's, by
    ``logits`` as :func:`check_packed`'s (``"resnet"``: 1e-3 of max|JAX
    logits|, the ResNet packed-parity criterion)."""
    got, want = out[("carry", carry, fused)]
    assert got.shape == want.shape == (2, 10)
    if logits == "resnet":
        assert np.max(np.abs(got - want)) <= 1e-3 * np.max(np.abs(want))
    elif logits == "exact":
        np.testing.assert_array_equal(got, want)
    else:
        noise = np.abs(out["quant"] - out["fp32"])
        assert np.max(np.abs(got - want)) <= max(noise.max(), 1e-6 * np.abs(want).max())
        assert np.array_equal(got.argmax(-1), want.argmax(-1))


def check_carry_vs_float_skip(out):
    """The skip path sees fake_quant(x): the carry's f32 logits within JAX's
    8e-2 of max|logits| (tests/test_precision.py) of the float carry's, with
    the same argmax, and different from them; quant mode ignores the flag."""
    got, _ = out[("carry", "float32", False)]
    ref = out["no_carry"]
    assert 0 < np.max(np.abs(got - ref)) <= 8e-2 * np.max(np.abs(ref))
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    on, off = out["quant_flag"]
    np.testing.assert_array_equal(on, off)
