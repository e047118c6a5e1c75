"""The activation quantize (kernel KQ's function) against the JAX package.

``quantize_tpu_torch.ops.qmatmul.quantize_act_int8`` on CPU tensors runs its
plain version, which must equal JAX's ``quantize_act_int8``
(``quantize_tpu/ops/pallas/qmatmul.py:66-79``) bit for bit: a true float32
division, one subtraction, round half to even, the clamp and the -128 shift
of unsigned grids, for float32 and bf16 inputs. The inputs are seeded numpy
arrays with values placed exactly on the grid's half-integers (where round
half to even decides), values past both ends of the grid, and odd lengths
(the kernel's masked tail on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.ops.pallas.qmatmul import quantize_act_int8 as jax_quantize_act
from quantize_tpu_torch.ops import launch_counts
from quantize_tpu_torch.ops.qmatmul import quantize_act_int8, quantize_act_int8_plain

torch.set_num_threads(2)

# (scale, zero, qmin, qmax): an unsigned grid (shifted by -128 into int8)
# and a signed one, each with a zero point off the grid's origin
GRIDS = [(0.0375, -97.0, 0, 255), (0.02, 3.0, -128, 127), (0.5, 0.0, -128, 127)]


def _inputs(n, scale, zero, seed):
    """n float32 values: a normal spread reaching well past the grid's ends,
    a quarter placed on half-integers of the grid (x / scale - zero = k + 0.5,
    exact in float32 for these scales), and the exact ends of the range."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 200 * scale).astype(np.float32)
    k = rng.integers(-300, 300, size=n).astype(np.float32)
    half = ((k + np.float32(0.5) + np.float32(zero)) * np.float32(scale)).astype(np.float32)
    pick = rng.random(n) < 0.25
    x[pick] = half[pick]
    x[: min(n, 4)] = np.array([np.inf, -np.inf, 1e30, -1e30], np.float32)[: min(n, 4)]
    return x


@pytest.mark.parametrize("n", [1, 15, 17, 4099, 65536 + 13])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax_bit_for_bit(n, grid, dtype):
    scale, zero, qmin, qmax = grid
    x = _inputs(n, scale, zero, seed=n + qmin + 1000)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, zj = jax_quantize_act(xj, jnp.float32(scale), jnp.float32(zero), qmin, qmax)
    before = launch_counts()["quantize_act_int8"]
    qt, zt = quantize_act_int8(xt, torch.tensor(scale), torch.tensor(zero), qmin, qmax)
    assert launch_counts()["quantize_act_int8"] == before  # CPU: the plain version
    assert qt.dtype == torch.int8 and tuple(qt.shape) == (n,)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(zt) == float(zj)


@pytest.mark.parametrize("shape", [(2, 7, 9, 12), (3, 5, 64), (33, 17)])
def test_quantize_any_shape_and_python_scalars(shape):
    """The JAX signature: any shape, scale and zero as Python floats; the
    wrapper and its plain version are one function on the CPU."""
    scale, zero, qmin, qmax = GRIDS[0]
    x = _inputs(int(np.prod(shape)), scale, zero, seed=len(shape)).reshape(shape)
    qj, zj = jax_quantize_act(jnp.asarray(x), scale, zero, qmin, qmax)
    qt, zt = quantize_act_int8(torch.from_numpy(x), scale, zero, qmin, qmax)
    qp, zp = quantize_act_int8_plain(torch.from_numpy(x), scale, zero, qmin, qmax)
    assert tuple(qt.shape) == shape
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert torch.equal(qt, qp) and float(zt) == float(zp) == float(zj)


def test_half_integers_round_to_even():
    """x / scale - zero exactly k + 0.5 rounds to the even neighbour, as
    JAX's round does (a round-half-away kernel would fail here)."""
    scale, zero = 0.25, 0.0
    k = np.arange(-20, 20, dtype=np.float32)
    x = ((k + np.float32(0.5)) * np.float32(scale)).astype(np.float32)
    qt, _ = quantize_act_int8(torch.from_numpy(x), torch.tensor(scale), torch.tensor(zero),
                              -128, 127)
    np.testing.assert_array_equal(qt.numpy(), np.rint(k + 0.5).astype(np.int8))
    qj, _ = jax_quantize_act(jnp.asarray(x), jnp.float32(scale), jnp.float32(zero), -128, 127)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
