"""Kernel K4's two routes (``csrc/w4a8_gemm.cu``), on the CPU.

The route is chosen from the shape before launch (``_w4a8_route``): the
warp-specialized ``wgmma`` kernel where K is a multiple of 32, over the
weights' K-major copy ``w_p4_kmajor``, which ``QuantDense`` makes once when
its packed weight is set; the ``mma.sync`` kernel for every other even K.
These tests hold the choice, the wgmma kernel's shared-memory mirror, the
copy and the fused q/k/v operands; the kernels themselves run on the card
(the ``cuda`` tests of ``tests/test_torch_package.py``). On the CPU every
route runs the plain version, so all results here are bit-equal.
"""
import numpy as np
import pytest
import torch

from quantize_tpu_torch.nn.attention import fused_w4_operands
from quantize_tpu_torch.ops.attention import SMEM_PER_BLOCK
from quantize_tpu_torch.ops.qmatmul import (_w4a8_route, _w4a8_tile, kmajor_packed,
                                            pack_int4_splithalf, quant_matmul_w4a8, w4a8_gemm,
                                            w4a8_gemm_plain)

torch.set_num_threads(2)


def _zoo_shapes():
    """(K, N) of every W4A8 dense layer of the ViT zoo (ViT-B/16, B/32,
    L/16, L/32, H/14) and of CLIP's towers (ViT-B/32 and B/16 vision at 768,
    ViT-L/14 at 1024, text at 512 and 768): the fused qkv, fc1, fc2 and the
    1000-class head."""
    shapes = set()
    for hidden, mlp in ((768, 3072), (1024, 4096), (1280, 5120), (512, 2048)):
        shapes |= {(hidden, 3 * hidden), (hidden, mlp), (mlp, hidden), (hidden, 1000)}
    return sorted(shapes)


@pytest.mark.parametrize("k,n", _zoo_shapes())
def test_every_zoo_shape_takes_the_wgmma_route(k, n):
    """Whatever N: the wgmma kernel takes any N (its tile, 256, 128 or 64
    columns wide, is zero-filled past N)."""
    assert _w4a8_route(k) == "wgmma" and _w4a8_tile(n)[0] == (256 if n > 128 else 128)
    assert _w4a8_route(k, aligned=False) == "mma_sync"


@pytest.mark.parametrize("k", [2, 16, 34, 40, 48, 200, 770, 3080, 131072])
def test_even_k_off_the_32_grid_or_too_long_takes_the_mma_sync_route(k):
    assert (k % 32 or k >= 1 << 17) and _w4a8_route(k) == "mma_sync"


def test_odd_k_is_refused_by_both_routes():
    with pytest.raises(ValueError, match="must be even"):
        _w4a8_route(769)


@pytest.mark.parametrize("n,bn,smem", [(16, 64, 100_928), (64, 64, 100_928),
                                       (65, 128, 134_720), (128, 128, 134_720),
                                       (129, 256, 202_304), (1000, 256, 202_304),
                                       (5120, 256, 202_304)])
def test_wgmma_tile_and_its_shared_memory_fit_the_card(n, bn, smem):
    """``Tile<BN>::SMEM``: a ring of four stages of 16 KB of A and BN * 128
    bytes of W (the int32 tile staged over it is smaller), 64 bytes of
    barriers, four column vectors, the row sums and 1 KB of slack."""
    assert _w4a8_tile(n) == (bn, smem)
    assert smem <= SMEM_PER_BLOCK == 227 * 1024


def _operands(m, k, n, wz0, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-8, 8, (k, n), dtype=np.int8))
    w_zero = np.zeros(n) if wz0 else rng.normal(size=n)
    return [q, torch.tensor(131.5), torch.tensor(0.02), pack_int4_splithalf(w),
            w.sum(0, dtype=torch.int32), torch.from_numpy(rng.random(n).astype(np.float32) * 0.01),
            torch.from_numpy(w_zero.astype(np.float32)),
            torch.from_numpy(rng.normal(size=n).astype(np.float32))]


def test_kmajor_packed_is_the_transposed_packed_weight():
    w_p4 = _operands(4, 96, 40, True)[3]
    w_km = kmajor_packed(w_p4)
    assert w_km.shape == (40, 48) and w_km.is_contiguous() and torch.equal(w_km, w_p4.t())


@pytest.mark.parametrize("m,k,n", [(5, 96, 40), (7, 200, 33)])
@pytest.mark.parametrize("wz0", [True, False])
def test_the_kmajor_copy_alone_gives_the_same_product(m, k, n, wz0):
    """The wrapper and the plain version take the weight as ``w_p4``, as its
    K-major copy alone (what the fused q/k/v hands the wgmma route), or as
    both: bit-equal."""
    args = _operands(m, k, n, wz0)
    w_km = kmajor_packed(args[3])
    want = w4a8_gemm_plain(*args, wz0)
    only_km = args[:3] + [None] + args[4:]
    for got in (w4a8_gemm(*args, wz0), w4a8_gemm(*args, wz0, w_km),
                w4a8_gemm(*only_km, wz0, w_km), w4a8_gemm_plain(*only_km, wz0, w_km)):
        assert torch.equal(got, want)
    x = torch.randn(m, k)
    a = (torch.tensor(0.05), torch.tensor(-3.0), 0, 255)
    assert torch.equal(quant_matmul_w4a8(x, *a, None, *args[5:8], None, wz0, w_km=w_km),
                       quant_matmul_w4a8(x, *a, args[3], *args[5:8], None, wz0))
    with pytest.raises(ValueError, match="needs w_p4 or its K-major copy"):
        w4a8_gemm(*only_km, wz0)


def test_fused_qkv_operands_follow_the_route():
    """The fused q/k/v weight: on the wgmma route the three K-major copies
    along dim 0, which is the K-major copy of the three packed weights along
    dim 1; elsewhere the packed weights along dim 1 alone."""
    bufs = []
    for seed in range(3):
        w_p4 = _operands(2, 96, 40 + 8 * seed, True, seed)[3]
        bufs.append({"w_p4": w_p4, "w_p4_kmajor": kmajor_packed(w_p4)})
    packed = torch.cat([b["w_p4"] for b in bufs], dim=1)
    w, w_km = fused_w4_operands(bufs, torch.device("cuda"), 96)
    assert w is None and w_km.is_contiguous() and torch.equal(w_km, kmajor_packed(packed))
    w, w_km = fused_w4_operands(bufs, torch.device("cpu"), 96)
    assert w_km is None and torch.equal(w, packed)
    # K = 200: the mma.sync route reads the packed weights
    w, w_km = fused_w4_operands(bufs, torch.device("cuda"), 200)
    assert w_km is None and torch.equal(w, packed)
