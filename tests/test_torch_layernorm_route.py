"""Kernel K7's two routes (``csrc/layernorm.cu``): LayerNorm fused with the
int8 activation quantize.

The route is chosen from the shape before launch (``_ln_q_route``): the
``vector`` kernel, which holds a row in registers, where d is a multiple of
128 up to 2,048 (every LayerNorm width of the ViT and CLIP zoo), and the
``scalar`` kernel for every other d. On the CPU every route runs the plain
version; the tests marked ``cuda`` hold each route against it on the card,
bit for bit (run there with ``--noconftest``: this file imports no JAX).
"""
import numpy as np
import pytest
import torch

from quantize_tpu_torch.ops import launch_counts, reset_launch_counts
from quantize_tpu_torch.ops.layernorm import (LN_Q_VEC_MAX_D, _ln_q_route, layernorm_quant_int8,
                                              layernorm_quant_int8_plain,
                                              layernorm_quant_int8_rows)

torch.set_num_threads(2)

# the LayerNorm widths of the zoo: CLIP's text tower (512), ViT-B (768),
# ViT-L (1024), ViT-H (1280)
ZOO_WIDTHS = (512, 768, 1024, 1280)


@pytest.mark.parametrize("d", ZOO_WIDTHS + (128, 256, 384, LN_Q_VEC_MAX_D))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zoo_widths_take_the_vector_route(d, dtype):
    assert _ln_q_route(d, dtype) == "vector"
    assert _ln_q_route(d, dtype, aligned=False) == "scalar"


@pytest.mark.parametrize("d", [1, 32, 64, 100, 200, 1000, 2176, 4096, 65536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_other_widths_take_the_scalar_route(d, dtype):
    """Off the 128 grid, or wider than a row the registers hold."""
    assert (d % 128 or d > LN_Q_VEC_MAX_D) and _ln_q_route(d, dtype) == "scalar"


def test_the_route_takes_float32_and_bfloat16_only():
    with pytest.raises(ValueError, match="unsupported dtype"):
        _ln_q_route(768, torch.float16)


def _ln_args(r, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(r, d)) * 3 + 0.5).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy((rng.random(d) + 0.5).astype(np.float32))
    beta = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    return x, gamma, beta


@pytest.mark.parametrize("qmin,qmax", [(0, 255), (-128, 127)])
def test_cpu_rows_take_the_plain_version_on_no_route(qmin, qmax):
    """A CPU tensor runs the plain version and counts no launch on either
    route, whatever the width."""
    reset_launch_counts()
    for d in (768, 200):
        x, g, b = _ln_args(11, d, torch.float32)
        a_s, a_z = torch.tensor(0.04), torch.tensor(-100.0 if qmin >= 0 else 3.0)
        q, z = layernorm_quant_int8_rows(x, g, b, 1e-6, a_s, a_z, qmin, qmax)
        q_p, z_p = layernorm_quant_int8_plain(x, g, b, 1e-6, a_s, a_z, qmin, qmax)
        assert q.dtype == torch.int8 and torch.equal(q, q_p) and float(z) == float(z_p)
    assert launch_counts()["layernorm_quant_int8"] == 0
    assert layernorm_quant_int8_rows.route_launches == {"vector": 0, "scalar": 0}


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the GPU machine)")


def _cuda_case(r, d, dtype, qmin):
    """Random rows on the card, quantized with s_a = 0.04 (y spans about a
    hundred grid steps, so every row crosses many round() boundaries)."""
    x, g, b = (t.cuda() for t in _ln_args(r, d, dtype, seed=d + r))
    a_s = torch.tensor(0.04, device="cuda")
    a_z = torch.tensor(-100.0 if qmin >= 0 else 3.0, device="cuda")
    return x, g, b, a_s, a_z


# (R, d): R not a multiple of the 8 rows a block; d at every zoo width, the
# route's ends and a width of each parity of d / 128
VECTOR_CASES = [(517, 768), (1, 768), (25600, 768), (333, 512), (77, 1024), (129, 1280),
                (9, 128), (200, 384), (31, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,d", VECTOR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qmin,qmax", [(0, 255), (-128, 127)])
def test_cuda_vector_route_is_bit_equal_to_the_plain_version(cuda_card, r, d, dtype, qmin,
                                                             qmax):
    x, g, b, a_s, a_z = _cuda_case(r, d, dtype, qmin)
    reset_launch_counts()
    q, z = layernorm_quant_int8_rows(x, g, b, 1e-6, a_s, a_z, qmin, qmax)
    q_p, z_p = layernorm_quant_int8_plain(x, g, b, 1e-6, a_s, a_z, qmin, qmax)
    torch.cuda.synchronize()
    assert layernorm_quant_int8_rows.route_launches == {"vector": 1, "scalar": 0}
    assert torch.equal(q, q_p) and float(z) == float(z_p)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 1000, 2176])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_scalar_route_is_bit_equal_to_the_plain_version(cuda_card, d, dtype):
    x, g, b, a_s, a_z = _cuda_case(301, d, dtype, 0)
    reset_launch_counts()
    q, z = layernorm_quant_int8_rows(x, g, b, 1e-6, a_s, a_z, 0, 255)
    q_p, z_p = layernorm_quant_int8_plain(x, g, b, 1e-6, a_s, a_z, 0, 255)
    torch.cuda.synchronize()
    assert layernorm_quant_int8_rows.route_launches == {"vector": 0, "scalar": 1}
    assert torch.equal(q, q_p) and float(z) == float(z_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_misaligned_rows_take_the_scalar_route(cuda_card, dtype):
    """Rows that start off the vector loads' alignment (a view one element
    into its storage) go to the scalar kernel, bit-equal all the same."""
    x, g, b, a_s, a_z = _cuda_case(65, 768, dtype, -128)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    x_off = buf[1:].view(65, 768).copy_(x)
    reset_launch_counts()
    q, _ = layernorm_quant_int8_rows(x_off, g, b, 1e-6, a_s, a_z, -128, 127)
    q_p, _ = layernorm_quant_int8_plain(x, g, b, 1e-6, a_s, a_z, -128, 127)
    torch.cuda.synchronize()
    assert layernorm_quant_int8_rows.route_launches == {"vector": 0, "scalar": 1}
    assert torch.equal(q, q_p)


@pytest.mark.cuda
def test_cuda_public_entry_on_a_vit_shape_takes_the_vector_route(cuda_card):
    """``layernorm_quant_int8`` on ViT-B/16's (B, S, E) activations at batch 2."""
    x, g, b, a_s, a_z = _cuda_case(400, 768, torch.float32, 0)
    reset_launch_counts()
    q, z = layernorm_quant_int8(x.reshape(2, 200, 768), g, b, 1e-6, a_s, a_z, 0, 255)
    torch.cuda.synchronize()
    assert layernorm_quant_int8_rows.route_launches == {"vector": 1, "scalar": 0}
    q_p, _ = layernorm_quant_int8_plain(x, g, b, 1e-6, a_s, a_z, 0, 255)
    assert torch.equal(q.reshape(400, 768), q_p)
