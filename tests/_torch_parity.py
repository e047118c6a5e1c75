"""One model through the JAX package and the port on the CPU, for the
model-level parity tests (``tests/test_torch_mobilenet*.py``,
``tests/test_torch_wideresnet.py``).

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
