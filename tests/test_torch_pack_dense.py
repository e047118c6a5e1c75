"""Dense bit packing in the port (``quantize_tpu_torch.quant.pack`` and the
native host packer ``quantize_tpu_torch.engine``) against the JAX package.

* ``tpack`` gives JAX's bytes and descriptor for 1-8 bits, signed and
  unsigned, on seeded values that include out-of-range values and exact
  .5 values (rounded half to even, then clamped); ``tunpack`` inverts it
  and reads JAX's buffers.
* The port's native library (its own copy of ``tpack.cpp``, built by
  ``g++`` into ``quantize_tpu_torch/_build/``) builds, and its bytes equal
  JAX's engine's and the plain version's; each unpacks the others.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quantize_tpu import engine as jax_engine
from quantize_tpu.quant.pack import tpack as jax_tpack
from quantize_tpu.quant.pack import tunpack as jax_tunpack
from quantize_tpu_torch import engine
from quantize_tpu_torch.quant import PackDescriptor, tpack, tunpack

torch.set_num_threads(2)

BITS = range(1, 9)


def _values(n_bits: int, signed: bool, seed: int) -> np.ndarray:
    """Seeded values over twice the grid's range (so some clamp), with exact
    .5 values on and off the grid."""
    rng = np.random.default_rng(seed)
    span = 1 << n_bits
    x = rng.uniform(-span, span, size=(5, 7, 3)).astype(np.float32)
    halves = np.arange(-span, span, dtype=np.float32) + 0.5
    x.reshape(-1)[: min(halves.size, x.size)] = halves[: x.size]
    if not signed:
        x = np.abs(x)
    return x


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("n_bits", BITS)
def test_tpack_bytes_equal_jax(n_bits, signed):
    x = _values(n_bits, signed, seed=n_bits)
    packed, des = tpack(torch.from_numpy(x), n_bits, signed)
    want, jdes = jax_tpack(jnp.asarray(x), n_bits, signed)
    assert packed.dtype == torch.uint8 and packed.shape == (-(-x.size * n_bits // 8),)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    assert des.to_json() == jdes.to_json()
    assert PackDescriptor.from_json(jdes.to_json()) == des
    # both unpack each other's buffers to the same clamped, rounded values
    got = tunpack(torch.from_numpy(np.array(want)), des)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_tunpack(jnp.asarray(want), jdes)))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("n_bits", BITS)
def test_tunpack_round_trips(n_bits, signed):
    lo, hi = (-(1 << (n_bits - 1)), (1 << (n_bits - 1)) - 1) if signed else (0, (1 << n_bits) - 1)
    q = torch.from_numpy(np.random.default_rng(n_bits).integers(lo, hi + 1, size=(3, 11, 2)))
    packed, des = tpack(q, n_bits, signed)
    for dtype in (torch.float32, torch.int32):
        back = tunpack(packed, des, dtype)
        assert back.dtype == dtype and torch.equal(back, q.to(dtype))


def test_native_library_builds_into_the_package():
    lib = engine.get_native()
    assert lib is not None, "g++ build of the port's native tpack failed"
    path = engine.lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "quantize_tpu_torch"
    assert engine.SRC.parent.parent == path.parent.parent / "engine"


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("n_bits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_native_bytes_equal_jax_engine_and_plain(n_bits, signed):
    x = _values(n_bits, signed, seed=100 + n_bits)
    native, des = engine.tpack(x, n_bits, signed)
    plain, _ = tpack(torch.from_numpy(x), n_bits, signed)
    want, _ = jax_engine.tpack(x, n_bits, signed)
    assert native.dtype == torch.uint8 and native.device.type == "cpu"
    np.testing.assert_array_equal(native.numpy(), np.asarray(want))
    assert torch.equal(native, plain)
    for dtype in (torch.float32, torch.int8):
        back = engine.tunpack(native, des, dtype)
        assert back.dtype == dtype
        assert torch.equal(back, tunpack(plain, des, dtype))
    np.testing.assert_array_equal(engine.tunpack(np.asarray(want), des).numpy(),
                                  jax_engine.tunpack(np.asarray(want), des))


def test_native_fallback_warns_once(monkeypatch, caplog):
    """Without a compiler the plain version runs, with one warning."""
    def no_compiler():
        raise FileNotFoundError("g++")

    monkeypatch.setattr(engine, "_lib", None)
    monkeypatch.setattr(engine, "_tried", False)
    monkeypatch.setattr(engine, "build", no_compiler)
    x = torch.arange(-8, 8, dtype=torch.float32)
    with caplog.at_level("WARNING", logger="quantize_tpu_torch.engine"):
        packed, des = engine.tpack(x, 4, True)
        back = engine.tunpack(packed, des)
    assert torch.equal(packed, tpack(x, 4, True)[0]) and torch.equal(back, x)
    assert len([r for r in caplog.records if "falls back" in r.getMessage()]) == 1
