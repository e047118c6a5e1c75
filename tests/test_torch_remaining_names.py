"""The last public names of the JAX package that the port lacked, each held
against JAX's on seeded inputs on the CPU.

* ``quant.fakequant.set_quant_sim_dtype`` / ``quant_sim_dtype``: under
  ``"bfloat16"`` the port's ``fake_quant`` runs the divide/round/clamp/
  dequant chain in bf16, each op rounded to bf16, as eager JAX does; on
  ``tests/test_fakequant.py::test_bf16_sim_dtype_close_and_restores``'s
  inputs (and an asymmetric per-tensor grid) the outputs and the input
  gradients are bit-equal to eager JAX's under the same switch (the scale
  and zero gradients, bf16 sums over the rows, agree within a few bf16
  roundings of their terms' magnitudes: the packages accumulate them
  differently), JAX's own bounds against f32 hold, the conditions are JAX's (a
  float32 input, no ``round_fn``, no ``awq_scale``), and None, "float32"
  and "f32" restore the exact f32 chain.
* ``ops.ref.im2col`` bit-equal to JAX's (SAME, VALID and explicit padding,
  strides 1 and 2, square and oblong windows); ``ops.ref.quant_matmul_wo_ref``
  and ``ops.qmatmul.quant_matmul_w8a8_xla`` (K1's math as plain PyTorch)
  within ``tests/test_qmatmul.py``'s tolerances (rtol 1e-4, atol 1e-4) of
  JAX's, their int8 activations bit-equal.

``set_matmul_backend``/``matmul_backend`` are not ported (ROADMAP §1): JAX's
switch picks XLA's int8 dot or its Pallas K1, where the port has one
implementation of that math on the card, the hand-written kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantize_tpu_torch as qtt
from quantize_tpu.ops.pallas.qmatmul import quant_matmul_w8a8_xla as jax_w8a8_xla
from quantize_tpu.ops.pallas.qmatmul import quantize_act_int8 as jax_quantize_act_int8
from quantize_tpu.ops.ref import im2col as jax_im2col
from quantize_tpu.ops.ref import quant_matmul_wo_ref as jax_wo_ref
from quantize_tpu.quant import fakequant as jfq
from quantize_tpu_torch.ops.qmatmul import quant_matmul_w8a8_xla, quantize_act_int8_plain
from quantize_tpu_torch.ops.ref import im2col, quant_matmul_wo_ref
from quantize_tpu_torch.quant import fakequant as tfq

torch.set_num_threads(2)


def _sim_case(name):
    """(x, scale, zero, qmin, qmax): test_fakequant's per-channel case, and
    an asymmetric per-tensor one."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    if name == "channel":
        scale = (np.abs(rng.normal(size=(32,))) * 0.01 + 0.001).astype(np.float32)
        return x, scale, np.zeros((32,), np.float32), -128, 127
    return (x, np.array([0.013], np.float32), np.array([-117.0], np.float32), 0, 255)


@pytest.fixture
def bf16_switch():
    """Both packages' switch at bfloat16 inside the test, restored after."""
    jfq.set_quant_sim_dtype("bfloat16")
    tfq.set_quant_sim_dtype("bfloat16")
    yield
    jfq.set_quant_sim_dtype(None)
    tfq.set_quant_sim_dtype(None)


def _jax_fq(x, s, z, lo, hi):
    def f(x, s, z):
        return jfq.fake_quant(x, s, z, lo, hi)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(s), jnp.asarray(z))
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(g)))]


def _port_fq(x, s, z, lo, hi):
    xs, ss, zs = (torch.tensor(a, requires_grad=True) for a in (x, s, z))
    out = tfq.fake_quant(xs, ss, zs, lo, hi)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=x.shape).astype(np.float32))
    out.backward(g)
    return [t.detach().numpy() for t in (out, xs.grad, ss.grad, zs.grad)]


def _row_terms(x, s, z, lo, hi):
    """The magnitude that the reductions of the scale and zero gradients
    sum over the rows: each is the sum of two paths that nearly cancel,
    the dequantize's (``g * (q + z)``, ``g * s``) and the quantize's
    (``-g * x / s``, ``-g * s``)."""
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float64)
    q = np.clip(np.round(x / s - z), lo, hi)
    return (np.abs(g * (q + z)).sum(0) + np.abs(g * x / s).sum(0),
            2 * np.abs(g * s).sum(0))


@pytest.mark.parametrize("case", ["channel", "tensor"])
def test_bf16_fake_quant_matches_eager_jax(bf16_switch, case):
    """The output and the input gradient bit-equal. The scale and zero
    gradients are bf16 sums over the rows of two paths that nearly cancel,
    which the two packages accumulate differently (an accepted divergence):
    each within 2^-6 of the paths' summed magnitudes, a few bf16
    roundings of them."""
    x, s, z, lo, hi = _sim_case(case)
    want = _jax_fq(x, s, z, lo, hi)
    got = _port_fq(x, s, z, lo, hi)
    for name, a, b in zip(("out", "dx", "dscale", "dzero"), got, want):
        assert a.dtype == b.dtype == np.float32, name
    np.testing.assert_array_equal(got[0], want[0], err_msg="out")
    np.testing.assert_array_equal(got[1], want[1], err_msg="dx")
    for name, a, b, mag in zip(("dscale", "dzero"), got[2:], want[2:],
                               _row_terms(x, s, z, lo, hi)):
        mag = mag.sum() if a.size == 1 else mag
        assert (np.abs(a - b) <= 2.0 ** -6 * mag).all(), (name, np.abs(a - b).max())


@pytest.mark.parametrize("case", ["channel", "tensor"])
def test_bf16_within_jax_bounds_of_f32_and_restores(case):
    x, s, z, lo, hi = _sim_case(case)
    args = [torch.from_numpy(a) for a in (x, s, z)]
    f32 = tfq.fake_quant(*args, lo, hi)
    for off in (None, "float32", "f32", torch.float32):
        tfq.set_quant_sim_dtype("bfloat16")
        assert tfq.quant_sim_dtype() == torch.bfloat16
        b16 = tfq.fake_quant(*args, lo, hi)
        tfq.set_quant_sim_dtype(off)
        assert tfq.quant_sim_dtype() is None
        assert torch.equal(tfq.fake_quant(*args, lo, hi), f32)  # exact f32 again
    assert b16.dtype == torch.float32 and not torch.equal(b16, f32)
    f32, b16 = f32.numpy(), b16.numpy()
    step = np.broadcast_to(s, f32.shape)
    bound = 1.02 * step + 0.005 * np.abs(f32) + 1e-6
    assert (np.abs(b16 - f32) <= bound).all()
    assert (np.abs(b16 - f32) <= 0.02 * step + 0.005 * np.abs(f32)).mean() > 0.8


def test_bf16_applies_under_jax_conditions(bf16_switch):
    """AdaRound's rounding, an AWQ scale and a bf16 input keep their own
    arithmetic; the switch is importable where JAX's is."""
    x, s, z, lo, hi = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                       for a in _sim_case("channel"))
    tfq.set_quant_sim_dtype(None)
    f32_round = tfq.fake_quant(x, s, z, lo, hi, round_fn=torch.round)
    awq = torch.linspace(0.5, 1.5, 64)
    f32_awq = tfq.fake_quant(x, s, z, lo, hi, awq_scale=awq, awq_axis=0)
    f_bf16 = tfq.fake_quant(x.bfloat16(), s, z, lo, hi)
    tfq.set_quant_sim_dtype("bfloat16")
    assert torch.equal(tfq.fake_quant(x, s, z, lo, hi, round_fn=torch.round), f32_round)
    assert torch.equal(tfq.fake_quant(x, s, z, lo, hi, awq_scale=awq, awq_axis=0), f32_awq)
    assert torch.equal(tfq.fake_quant(x.bfloat16(), s, z, lo, hi), f_bf16)
    assert qtt.quant.set_quant_sim_dtype is tfq.set_quant_sim_dtype
    assert qtt.quant.quant_sim_dtype() == torch.bfloat16


IM2COL = [((2, 7, 9, 3), 3, 3, (1, 1), "SAME"), ((2, 8, 8, 4), 3, 3, (2, 2), "SAME"),
          ((1, 9, 6, 5), 3, 2, (2, 1), "VALID"), ((2, 6, 7, 2), 1, 1, (1, 1), "SAME"),
          ((1, 10, 10, 3), 5, 3, (2, 2), [(2, 1), (0, 2)]), ((1, 7, 7, 8), 7, 7, (2, 2), "SAME")]


@pytest.mark.parametrize("shape,kh,kw,strides,padding", IM2COL,
                         ids=[f"{c[1]}x{c[2]}-s{c[3][0]}{c[3][1]}-{i}" for i, c in
                              enumerate(IM2COL)])
def test_im2col_matches_jax(shape, kh, kw, strides, padding):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want, hw_j = jax_im2col(jnp.asarray(x), kh, kw, strides, padding)
    got, hw_t = im2col(torch.from_numpy(x), kh, kw, strides, padding)
    assert tuple(hw_t) == tuple(hw_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mm_case(m=32, k=64, n=48, sym_w=True, seed=0):
    """tests/test_qmatmul.py's ``make_case``, as numpy."""
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


@pytest.mark.parametrize("bias", [True, False])
def test_quant_matmul_wo_ref_matches_jax(bias):
    x, _, _, w, w_s, w_z, b = _mm_case(24, 56, 40, sym_w=False, seed=6)
    b = b if bias else None
    want = jax_wo_ref(*(jnp.asarray(a) for a in (x, w, w_s, w_z)),
                      None if b is None else jnp.asarray(b))
    got = quant_matmul_wo_ref(*(torch.from_numpy(a) for a in (x, w, w_s, w_z)),
                              None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


W8A8_XLA = {"asym": dict(sym_w=False, seed=1), "sym_wz0": dict(sym_w=True, seed=2),
            "pre_q": dict(sym_w=False, seed=3), "col_sum": dict(sym_w=False, seed=4),
            "batched": dict(m=32, sym_w=False, seed=5)}


@pytest.mark.parametrize("case", sorted(W8A8_XLA))
def test_quant_matmul_w8a8_xla_matches_jax(case):
    x, a_s, a_z, w, w_s, w_z, b = _mm_case(**W8A8_XLA[case])
    if case == "batched":
        x = x.reshape(4, 8, -1)
    q_j, z_j = jax_quantize_act_int8(jnp.asarray(x), jnp.asarray(a_s), jnp.asarray(a_z), 0, 255)
    q_t, z_t = quantize_act_int8_plain(torch.from_numpy(x), torch.tensor(a_s),
                                       torch.tensor(a_z), 0, 255)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))  # the int8 activation
    assert float(z_t) == float(z_j)
    kw_j, kw_t = {}, {}
    if case == "sym_wz0":
        kw_j["w_zero_is_zero"] = kw_t["w_zero_is_zero"] = True
    if case == "pre_q":
        kw_j["pre_q"], kw_t["pre_q"] = (q_j, z_j), (q_t, z_t)
    if case == "col_sum":
        col = w.astype(np.int32).sum(0)
        kw_j["col_sum_w"], kw_t["col_sum_w"] = jnp.asarray(col), torch.from_numpy(col)
    want = jax_w8a8_xla(*(jnp.asarray(a) for a in (x, a_s, a_z)), 0, 255,
                        *(jnp.asarray(a) for a in (w, w_s, w_z, b)), **kw_j)
    got = quant_matmul_w8a8_xla(*(torch.from_numpy(np.asarray(a)) for a in (x, a_s, a_z)), 0,
                                255, *(torch.from_numpy(a) for a in (w, w_s, w_z, b)), **kw_t)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
