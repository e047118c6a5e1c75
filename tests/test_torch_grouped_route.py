"""Kernel K3g (the grouped int8 conv, ``csrc/qconv2d_grouped.cu``): its
tile and weight layout on the CPU, and on the card its launch against the
plain version, bit for bit, at the shapes of ``chip_smoke.py``'s K3g phase.

This file imports no JAX, so that its ``cuda`` tests run on the GPU
machine (``python -m pytest --noconftest -m cuda tests/test_torch_grouped_route.py``);
the parity with the JAX package is ``tests/test_torch_grouped_conv.py``.
"""
import pytest
import torch

from quantize_tpu_torch.ops import launch_counts, reset_launch_counts
from quantize_tpu_torch.ops.qconv import (K3G_SMEM_MAX, K3G_SMEM_TWO_BLOCKS, _grouped_tile,
                                          conv_zero_correction_map, grouped_weight,
                                          qconv2d_grouped_int8, qconv2d_grouped_int8_plain,
                                          resolve_padding)

torch.set_num_threads(2)

# (N, H, W, Ci, Co, G, k, stride, z_w == 0, out dtype): the golden case's
# shape (G 2, Ci/G 4), ResNeXt-50 32x4d's four grouped convs (Ci/G 4-32,
# the strided first blocks), ResNeXt-101 32x8d's widths (Ci/G 8-64) and
# 64x4d's G = 64, group widths 1, 2 and 3, asymmetric weights, stride 2
# with JAX's asymmetric SAME padding (even H), bf16 output, and more than
# 64 output channels a group (a group split across blocks)
GROUPED_SHAPES = (
    (2, 8, 8, 8, 12, 2, 3, 1, True, "float32"),
    (2, 56, 56, 128, 128, 32, 3, 1, True, "float32"),
    (2, 56, 56, 256, 256, 32, 3, 2, True, "float32"),
    (2, 28, 28, 512, 512, 32, 3, 2, True, "bfloat16"),
    (2, 14, 14, 1024, 1024, 32, 3, 2, True, "float32"),
    (2, 7, 7, 1024, 1024, 32, 3, 1, True, "bfloat16"),
    (2, 14, 14, 2048, 2048, 32, 3, 1, True, "float32"),
    (2, 28, 28, 256, 256, 64, 3, 1, True, "float32"),
    (2, 9, 9, 24, 24, 24, 3, 1, False, "float32"),
    (2, 9, 9, 48, 48, 24, 3, 2, False, "float32"),
    (2, 9, 9, 36, 72, 12, 3, 1, False, "bfloat16"),
    (2, 16, 16, 64, 64, 4, 3, 1, False, "float32"),
    (3, 10, 10, 8, 260, 2, 3, 2, False, "float32"),
    (2, 11, 11, 20, 30, 5, 5, 2, False, "float32"),
)


def _args(shape, device, seed=0):
    n, h, w, ci, co, g, k, s, wz0, dt = shape
    gen = torch.Generator().manual_seed(seed)
    q = torch.randint(-128, 128, (n, h, w, ci), generator=gen).to(torch.int8)
    w_int = torch.randint(-127, 128, (k, k, ci // g, co), generator=gen).to(torch.int8)
    pads = resolve_padding("SAME", k, k, h, w, (s, s))
    corr = conv_zero_correction_map(w_int, h, w, (s, s), pads)
    w_zero = torch.zeros(co) if wz0 else torch.randn(co, generator=gen)
    args = (q, torch.tensor(131.0), torch.tensor(0.0123), w_int,
            torch.rand(co, generator=gen) * 0.01, w_zero, torch.randn(co, generator=gen),
            (s, s), pads, corr, wz0, getattr(torch, dt), g, grouped_weight(w_int, g))
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


@pytest.mark.parametrize("cig,cog,groups,want", [
    # ResNeXt-50 32x4d: whole groups to 64 output channels, 64 pixels
    (4, 4, 32, (16, 64, 4)), (8, 8, 32, (8, 64, 4)), (32, 32, 32, (2, 64, 4)),
    # 101 32x8d's last stage: one group of 64; 64x4d: G = 64
    (64, 64, 32, (1, 64, 4)), (4, 4, 64, (16, 64, 4)),
    # group widths 1-3 (depthwise and odd), and a group wider than 64
    (1, 1, 24, (24, 64, 1)), (3, 6, 12, (10, 64, 2)), (4, 130, 2, (1, 64, 2)),
])
def test_grouped_tile_takes_whole_groups(cig, cog, groups, want):
    gb, bp, cr, smem = _grouped_tile(9, cig, cog, groups)
    assert (gb, bp, cr) == want
    assert smem <= K3G_SMEM_TWO_BLOCKS and cog % cr == 0


def test_grouped_tile_shrinks_then_refuses_by_name():
    """Wide groups take fewer pixels a block, and one block an SM past
    113 KB; a shape whose smallest tile exceeds the card's shared memory
    (3 x 3 taps over 384 channels a group) raises ValueError before launch,
    through this mirror of the kernel's limit."""
    gb, bp, _, smem = _grouped_tile(9, 128, 64, 2)
    assert (gb, bp) == (1, 32) and smem <= K3G_SMEM_TWO_BLOCKS
    gb, bp, _, smem = _grouped_tile(9, 256, 64, 2)
    assert (gb, bp) == (1, 32) and K3G_SMEM_TWO_BLOCKS < smem <= K3G_SMEM_MAX
    for cig in (384, 1024):
        with pytest.raises(ValueError, match="qconv2d_grouped_int8.*shared memory"):
            _grouped_tile(9, cig, 64, 2)


def test_grouped_weight_layout():
    """Word (g, tap, w, j) holds input channels 4w .. 4w + 3 of group g for
    output channel j of the group, zeros past Ci/G."""
    gen = torch.Generator().manual_seed(3)
    w = torch.randint(-128, 128, (3, 3, 3, 12), generator=gen).to(torch.int8)
    wg = grouped_weight(w, 4)
    assert wg.shape == (4, 9, 1, 3, 4) and wg.is_contiguous()
    for g, tap, j, b in ((0, 0, 0, 0), (3, 8, 2, 2), (1, 4, 1, 1), (2, 5, 0, 2)):
        assert int(wg[g, tap, 0, j, b]) == int(w[tap // 3, tap % 3, b, g * 3 + j])
    assert not wg[..., 3].any()


def test_grouped_wrapper_on_the_cpu_is_the_plain_version():
    args = _args(GROUPED_SHAPES[0], "cpu")
    reset_launch_counts()
    assert torch.equal(qconv2d_grouped_int8(*args), qconv2d_grouped_int8_plain(*args))
    assert launch_counts()["qconv2d_grouped"] == 0


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the GPU machine)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_cuda_grouped_conv_is_bit_equal_to_the_plain_version(cuda_card, shape):
    args = _args(shape, "cuda", seed=sum(shape[:8]))
    reset_launch_counts()
    got = qconv2d_grouped_int8(*args)
    torch.cuda.synchronize()
    assert launch_counts()["qconv2d_grouped"] == 1
    want = qconv2d_grouped_int8_plain(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
def test_cuda_grouped_conv_refuses_before_launch(cuda_card):
    q = torch.zeros((1, 4, 4, 2048), dtype=torch.int8, device="cuda")
    w = torch.zeros((3, 3, 1024, 64), dtype=torch.int8, device="cuda")
    corr = torch.zeros((1, 4, 4, 64), device="cuda")
    one = torch.tensor(1.0, device="cuda")
    reset_launch_counts()
    with pytest.raises(ValueError, match="qconv2d_grouped_int8.*shared memory"):
        qconv2d_grouped_int8(q, one, one, w, torch.ones(64, device="cuda"),
                             torch.zeros(64, device="cuda"), None, (1, 1), ((1, 1), (1, 1)),
                             corr, True, torch.float32, 2)
    assert launch_counts()["qconv2d_grouped"] == 0
