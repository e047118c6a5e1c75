"""The port's straight-through fake quant and AdaRound primitives held
against the JAX package's on the CPU, forward and gradient (JAX eager, so
XLA fuses nothing).

* ``quantize_core`` / ``fake_quant`` (per-channel and per-tensor scales,
  with a static scale, with an AWQ scale, with AdaRound rounding): the
  inputs include values exactly on qmin and qmax and on grid midpoints
  (power-of-two scales make x/scale exact there). The forward and the
  gradient with respect to x must be bit-equal; those with respect to
  scale, zero and V within rtol 1e-5, plus 1e-5 of the tensor's largest
  entry: a per-channel gradient is the difference of two sums (the dequant
  and the quantize paths, each ~|q| a term) that nearly cancel, and XLA
  and PyTorch add their terms in different orders.
* ``rect_sigmoid``, ``init_v``, ``regularization`` (β 20, 2 and a value of
  the schedule), ``adaround_round``: forward and gradient within rtol 1e-6,
  an absolute 2^-24 (one float32 ulp at 0.5-1) allowed where the value
  itself is near 0 (JAX's float32 sigmoid and log, XLA's own, differ from
  PyTorch's by an ulp on some inputs); the gradient that ``jnp.clip``
  passes at an exact endpoint (0.5) is mirrored; rounding decisions equal.
* ``beta_schedule``: bit-equal over a whole run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.quant import adaround as jada
from quantize_tpu.quant import fakequant as jfq
from quantize_tpu_torch.quant import adaround as tada
from quantize_tpu_torch.quant import fakequant as tfq

torch.set_num_threads(2)
ULP = 2.0 ** -24


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _inputs(per_channel: bool, qmin: int, qmax: int, seed: int = 0):
    """(x, scale, zero) of shape (64, 8) / (8,) or (1,), with exact grid
    points, both bounds and midpoints in every column."""
    rng = np.random.default_rng(seed)
    c = 8 if per_channel else 1
    scale = np.where(np.arange(c) % 2 == 0, 2.0 ** -rng.integers(2, 6, c),
                     rng.uniform(0.01, 0.1, c)).astype(np.float32)
    zero = (np.zeros(c) if qmin < 0 else -rng.integers(0, qmax // 2, c)).astype(np.float32)
    v = rng.uniform(qmin - 3, qmax + 3, (64, 8)).astype(np.float32)
    v[:4] = np.float32([qmin, qmax, qmin + 0.5, qmax - 0.5])[:, None]  # bounds, midpoints
    v[4:8] = np.floor(v[4:8]) + 0.5               # grid midpoints
    v[8:12] = np.round(v[8:12])                   # grid points
    x = ((v + zero) * scale).astype(np.float32)
    return x, scale, zero


def _grads_jax(fn, args):
    out = fn(*args)
    g = np.random.default_rng(1).normal(size=out.shape).astype(np.float32)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * g), argnums=tuple(range(len(args))))(*args)
    return np.asarray(out), [np.asarray(x) for x in grads], g


def _grads_torch(fn, args, g):
    ts = [_t(a, grad=True) for a in args]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [np.zeros(t.shape, np.float32) if t.grad is None
                                  else t.grad.numpy() for t in ts]


def _reduced(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                               err_msg=name)


CASES = {
    "quantize_core-channel-s8": dict(per_channel=True, q=(-128, 127), fn="core"),
    "fake_quant-channel-s8": dict(per_channel=True, q=(-128, 127), fn="fq"),
    "fake_quant-tensor-u8": dict(per_channel=False, q=(0, 255), fn="fq"),
    "fake_quant-channel-s4-static": dict(per_channel=True, q=(-8, 7), fn="fq_static"),
    "fake_quant-channel-u4-awq": dict(per_channel=True, q=(0, 15), fn="fq_awq"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fake_quant_gradients_match_jax(case):
    c = CASES[case]
    qmin, qmax = c["q"]
    x, s, z = _inputs(c["per_channel"], qmin, qmax)
    extra = np.random.default_rng(2).uniform(0.5, 2.0, 8).astype(np.float32)
    j = {"core": lambda x, s, z: jfq.quantize_core(x, s, z, qmin, qmax),
         "fq": lambda x, s, z: jfq.fake_quant(x, s, z, qmin, qmax),
         "fq_static": lambda x, s, z: jfq.fake_quant(x, s, z, qmin, qmax,
                                                     static_scale=jnp.asarray(extra)),
         "fq_awq": lambda x, s, z: jfq.fake_quant(x[:8], s, z, qmin, qmax,
                                                  awq_scale=jnp.asarray(extra))}[c["fn"]]
    t = {"core": lambda x, s, z: tfq.quantize_core(x, s, z, qmin, qmax),
         "fq": lambda x, s, z: tfq.fake_quant(x, s, z, qmin, qmax),
         "fq_static": lambda x, s, z: tfq.fake_quant(x, s, z, qmin, qmax,
                                                     static_scale=_t(extra)),
         "fq_awq": lambda x, s, z: tfq.fake_quant(x[:8], s, z, qmin, qmax,
                                                  awq_scale=_t(extra))}[c["fn"]]
    out_j, (gx_j, gs_j, gz_j), g = _grads_jax(j, (jnp.asarray(x), jnp.asarray(s), jnp.asarray(z)))
    out_t, (gx_t, gs_t, gz_t) = _grads_torch(t, (x, s, z), g)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(gx_t, gx_j)
    _reduced(gs_t, gs_j, "d/d scale")
    _reduced(gz_t, gz_j, "d/d zero")
    if c["fn"] == "core":
        # the bounds pass the full gradient, beyond them none
        v = x / s - z
        assert (gx_t[0] != 0).all() and (gx_t[1] != 0).all()
        assert (gx_t[(v < qmin - 0.5) | (v > qmax + 0.5)] == 0).all()


def _endpoint_v():
    """float32 V where JAX's pre-clip h is exactly 0 or exactly 1, found by
    stepping ulp by ulp from the analytic roots ±log(11)."""
    found = []
    for root, target in ((-np.log(11.0), 0.0), (np.log(11.0), 1.0)):
        v = np.float32(root)
        vs = [v]
        for _ in range(400):
            vs.append(np.nextafter(vs[-1], np.float32(np.inf)))
            vs.insert(0, np.nextafter(vs[0], np.float32(-np.inf)))
        cand = np.asarray(vs, np.float32)
        pre = np.asarray(jax.nn.sigmoid(jnp.asarray(cand)) * (jada.ZETA - jada.GAMMA) + jada.GAMMA)
        hit = cand[pre == target]
        assert hit.size, f"no float32 V puts h exactly at {target}"
        found.append(hit[0])
    return np.asarray(found, np.float32)


def _close(got, want, rtol=1e-6, name=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ULP, err_msg=name)


def test_rect_sigmoid_and_its_endpoint_gradient_match_jax():
    rng = np.random.default_rng(3)
    ends = _endpoint_v()
    v = np.concatenate([ends, rng.normal(0, 3, 500).astype(np.float32),
                        np.float32([-30, 30, 0])])
    out_j, (g_j,), g = _grads_jax(jada.rect_sigmoid, (jnp.asarray(v),))
    out_t, (g_t,) = _grads_torch(tada.rect_sigmoid, (v,), g)
    _close(out_t, out_j, name="h(V)")
    _close(g_t, g_j, name="dh/dV")
    assert out_t[0] == 0.0 and out_t[1] == 1.0
    # jnp.clip's half gradient at an exact endpoint, mirrored
    sig = 1 / (1 + np.exp(-ends.astype(np.float64)))
    np.testing.assert_allclose(g_j[:2] / g[:2], 0.5 * 1.2 * sig * (1 - sig), rtol=1e-5)
    np.testing.assert_allclose(g_t[:2] / g[:2], g_j[:2] / g[:2], rtol=1e-6)


def test_init_v_and_adaround_round_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 4, (256,)).astype(np.float32)
    x[:6] = [0.0, 1.0, -2.0, 0.5, -1.5, 3.25]  # whole and half fractions
    v_j = np.asarray(jada.init_v(jnp.asarray(x)))
    v_t = tada.init_v(_t(x)).numpy()
    _close(v_t, v_j, name="init_v")
    # h(V_init) is the fractional part
    frac = x - np.floor(x)
    np.testing.assert_allclose(tada.rect_sigmoid(_t(v_t)).numpy(),
                               np.clip(frac, -0.1 + 1e-6, 1.1 - 1e-6), atol=1e-5)
    # trained-looking offsets: the rounding decisions and the V gradient
    v = (v_j + rng.normal(0, 1.5, v_j.shape)).astype(np.float32)
    out_j, (gx_j, gv_j), g = _grads_jax(jada.adaround_round, (jnp.asarray(x), jnp.asarray(v)))
    out_t, (gx_t, gv_t) = _grads_torch(tada.adaround_round, (x, v), g)
    np.testing.assert_array_equal(out_t, out_j)  # the rounding decisions
    np.testing.assert_array_equal(gx_t, gx_j)    # floor passes nothing to x
    assert not gx_t.any()
    _close(gv_t, gv_j, name="d round / dV")
    # AdaRound rounding inside the fake quant: forward bit-equal, V gradient
    x2, s2, z2 = _inputs(True, -8, 7, seed=5)
    v2 = rng.normal(0, 1, x2.shape).astype(np.float32)

    def jfn(x, s, z, v):
        return jfq.fake_quant(x, s, z, -8, 7, round_fn=lambda t: jada.adaround_round(t, v))

    def tfn(x, s, z, v):
        return tfq.fake_quant(x, s, z, -8, 7, round_fn=lambda t: tada.adaround_round(t, v))

    out_j, grads_j, g = _grads_jax(jfn, tuple(jnp.asarray(a) for a in (x2, s2, z2, v2)))
    out_t, grads_t = _grads_torch(tfn, (x2, s2, z2, v2), g)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(grads_t[0], grads_j[0])
    for got, want in zip(grads_t[1:3], grads_j[1:3]):
        _reduced(got, want, "d/d scale, zero with AdaRound")
    _close(grads_t[3], grads_j[3], name="dV through the fake quant")


@pytest.mark.parametrize("beta", [20.0, 2.0, 11.349999])
def test_regularization_matches_jax(beta):
    rng = np.random.default_rng(6)
    v = np.concatenate([_endpoint_v(), rng.normal(0, 2, 300).astype(np.float32)])
    for reduction in ("mean", "sum", "none"):
        def jfn(v):
            return jada.regularization(v, jnp.float32(beta), reduction=reduction)

        out_j, (g_j,), g = _grads_jax(jfn, (jnp.asarray(v),))
        out_t, (g_t,) = _grads_torch(lambda v: tada.regularization(v, beta, reduction=reduction),
                                     (v,), g)
        _close(out_t, out_j, name=f"reg {reduction}")
        _close(g_t, g_j, name=f"d reg {reduction} / dV")


@pytest.mark.parametrize("total", [1, 7, 40, 1000])
def test_beta_schedule_bit_equal(total):
    for it in range(0, total + 1, max(total // 50, 1)):
        assert tada.beta_schedule(it, total) == float(jada.beta_schedule(it, total)), (it, total)
