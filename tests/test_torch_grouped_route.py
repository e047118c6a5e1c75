"""Kernel K3g (the grouped int8 conv, ``csrc/qconv2d_grouped.cu``): its
two routes, their tiles and weight layouts on the CPU, an emulation of the
tensor-core route's decomposition held against the plain version, and on
the card each launch against the plain version, bit for bit, at the shapes
of ``chip_smoke.py``'s K3g phase.

This file imports no JAX, so that its ``cuda`` tests run on the GPU
machine (``python -m pytest --noconftest -m cuda tests/test_torch_grouped_route.py``);
the parity with the JAX package is ``tests/test_torch_grouped_conv.py``.
"""
import pytest
import torch

from quantize_tpu_torch.ops import launch_counts, reset_launch_counts
from quantize_tpu_torch.ops.qconv import (K3G_SMEM_MAX, K3G_SMEM_TWO_BLOCKS, _grouped_route,
                                          _grouped_slice, _grouped_tile, blockdiag_weight,
                                          conv_zero_correction_map, grouped_kernel_weight,
                                          grouped_weight, qconv2d_grouped_int8,
                                          qconv2d_grouped_int8_plain, resolve_padding)

torch.set_num_threads(2)

# (N, H, W, Ci, Co, G, k, stride, z_w == 0, out dtype, route): the golden
# case's shape (G 2, Ci/G 4), ResNeXt-50 32x4d's four grouped convs (Ci/G
# 4-32, the strided first blocks), ResNeXt-101 32x8d's widths (Ci/G 8-64)
# and 64x4d's G = 64, group widths 1, 2 and 3, asymmetric weights, stride 2
# with JAX's asymmetric SAME padding (even H), bf16 output, and more than 64
# output channels a group (a group split across blocks); then asymmetric
# weights on the wgmma route at Ci/G 4 (stride 2, bf16), 8 (a 1 x 1 kernel,
# ragged M), 32 and 64, a width the wgmma route takes with C not a
# multiple of 64 (the dp4a route's), and a 5 x 5 kernel at Ci/G = Co/G 4
GROUPED_SHAPES = (
    (2, 8, 8, 8, 12, 2, 3, 1, True, "float32", "dp4a"),
    (2, 56, 56, 128, 128, 32, 3, 1, True, "float32", "wgmma"),
    (2, 56, 56, 256, 256, 32, 3, 2, True, "float32", "wgmma"),
    (2, 28, 28, 512, 512, 32, 3, 2, True, "bfloat16", "wgmma"),
    (2, 14, 14, 1024, 1024, 32, 3, 2, True, "float32", "wgmma"),
    (2, 7, 7, 1024, 1024, 32, 3, 1, True, "bfloat16", "wgmma"),
    (2, 14, 14, 2048, 2048, 32, 3, 1, True, "float32", "wgmma"),
    (2, 28, 28, 256, 256, 64, 3, 1, True, "float32", "wgmma"),
    (2, 9, 9, 24, 24, 24, 3, 1, False, "float32", "dp4a"),
    (2, 9, 9, 48, 48, 24, 3, 2, False, "float32", "dp4a"),
    (2, 9, 9, 36, 72, 12, 3, 1, False, "bfloat16", "dp4a"),
    (2, 16, 16, 64, 64, 4, 3, 1, False, "float32", "wgmma"),
    (3, 10, 10, 8, 260, 2, 3, 2, False, "float32", "dp4a"),
    (2, 11, 11, 20, 30, 5, 5, 2, False, "float32", "dp4a"),
    (2, 14, 14, 128, 128, 32, 3, 2, False, "bfloat16", "wgmma"),
    (3, 15, 15, 256, 256, 32, 1, 1, False, "float32", "wgmma"),
    (2, 10, 10, 64, 64, 2, 3, 1, False, "float32", "wgmma"),
    (2, 10, 10, 128, 128, 2, 3, 1, False, "float32", "wgmma"),
    (2, 12, 12, 96, 96, 12, 3, 1, True, "float32", "dp4a"),
    (2, 11, 11, 64, 64, 16, 5, 2, False, "float32", "wgmma"),
)
WGMMA_SHAPES = tuple(s for s in GROUPED_SHAPES if s[-1] == "wgmma")
# (Ci/G, G) of the grouped 3 x 3 convs of ResNeXt-50 32x4d, ResNeXt-101
# 32x8d and ResNeXt-101 64x4d, stage by stage
RESNEXT_WIDTHS = ((4, 32), (8, 32), (16, 32), (32, 32),
                  (8, 32), (16, 32), (32, 32), (64, 32),
                  (4, 64), (8, 64), (16, 64), (32, 64))


def _args(shape, device, seed=0):
    n, h, w, ci, co, g, k, s, wz0, dt, _ = shape
    gen = torch.Generator().manual_seed(seed)
    q = torch.randint(-128, 128, (n, h, w, ci), generator=gen).to(torch.int8)
    w_int = torch.randint(-127, 128, (k, k, ci // g, co), generator=gen).to(torch.int8)
    pads = resolve_padding("SAME", k, k, h, w, (s, s))
    corr = conv_zero_correction_map(w_int, h, w, (s, s), pads)
    w_zero = torch.zeros(co) if wz0 else torch.randn(co, generator=gen)
    args = (q, torch.tensor(131.0), torch.tensor(0.0123), w_int,
            torch.rand(co, generator=gen) * 0.01, w_zero, torch.randn(co, generator=gen),
            (s, s), pads, corr, wz0, getattr(torch, dt), g, grouped_kernel_weight(w_int, g))
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


@pytest.mark.parametrize("shape", GROUPED_SHAPES)
def test_grouped_route_mirror(shape):
    """The route each test shape takes, chosen from the shape alone."""
    n, h, w, ci, co, g, k, s, wz0, dt, route = shape
    assert _grouped_route(k * k, ci // g, co // g, g) == route


@pytest.mark.parametrize("cig,groups", RESNEXT_WIDTHS)
def test_grouped_route_takes_the_resnext_widths(cig, groups):
    """Every grouped conv of the zoo's ResNeXts takes the wgmma route, in
    slices of 32 channels (64 at Ci/G = 64); a misaligned operand takes the
    dp4a route."""
    assert _grouped_route(9, cig, cig, groups) == "wgmma"
    assert _grouped_route(9, cig, cig, groups, aligned=False) == "dp4a"
    assert _grouped_slice(cig) == (64 if cig == 64 else 32)


@pytest.mark.parametrize("taps,cig,cog,groups", [
    (9, 1, 1, 24), (9, 2, 2, 24), (9, 3, 6, 12), (9, 4, 130, 2), (9, 4, 6, 2),
    (9, 8, 8, 12), (9, 128, 128, 2), (9, 1024, 32, 2), (25, 4, 6, 5), (1 << 12, 32, 32, 2),
])
def test_grouped_route_leaves_the_rest_to_dp4a(taps, cig, cog, groups):
    """Group widths 1-3, Co/G != Ci/G, C not a multiple of 64, groups wider
    than 64 and a slice K of 2^17 or more stay on the dp4a route."""
    assert _grouped_route(taps, cig, cog, groups) == "dp4a"


@pytest.mark.parametrize("cig,groups", [(4, 32), (8, 16), (16, 8), (32, 4), (64, 2)])
def test_blockdiag_weight_layout(cig, groups):
    """Row co, tap t, slice channel c of the block-diagonal copy is
    w_int[kh, kw, c', co] where input channel NS * (co // NS) + c is channel
    c' of co's group, else 0: element by element."""
    co = cig * groups
    gen = torch.Generator().manual_seed(cig)
    w = torch.randint(-128, 128, (3, 3, cig, co), generator=gen).to(torch.int8)
    bd = blockdiag_weight(w, groups)
    ns = _grouped_slice(cig)
    assert bd.shape == (co, 9 * ns) and bd.dtype == torch.int8 and bd.is_contiguous()
    got = bd.reshape(co, 9, ns)
    want = torch.zeros_like(got)
    for c in range(co):
        for ic in range(ns):
            ch = ns * (c // ns) + ic  # the input channel
            if ch // cig == c // cig:
                want[c, :, ic] = w[:, :, ch - (c // cig) * cig, c].reshape(9)
    assert torch.equal(got, want)
    assert torch.equal(grouped_kernel_weight(w, groups), bd)


def test_grouped_kernel_weight_follows_the_route():
    gen = torch.Generator().manual_seed(5)
    w = torch.randint(-128, 128, (3, 3, 3, 12), generator=gen).to(torch.int8)
    assert torch.equal(grouped_kernel_weight(w, 4), grouped_weight(w, 4))


def _emulate_wgmma_route(q, z, a_s, w_int, ws, wz, bias, strides, pads, corr, wz0, out_dtype,
                         groups, w_bd):
    """The wgmma route of ``csrc/qconv2d_grouped.cu`` as the kernel indexes
    it: for each slice, the producer's 16-byte chunks of 128-byte stages
    (tap = k // NS, channel base the slice's, zeros at padding and past K),
    the slice's NS rows of the block-diagonal copy zero-padded to the
    stages, their integer product, the z_w row sums in 8 bins a slice (a
    group's sum the sum of its bins), and the epilogue in its order."""
    n, h, w_sp, c = q.shape
    kh, kw, cig, co = w_int.shape
    ns, taps = _grouped_slice(cig), kh * kw
    nks = -(-taps * ns // 128)
    (pt, pb), (pl, pr) = pads
    sh, sw = strides
    oh, ow = (h + pt + pb - kh) // sh + 1, (w_sp + pl + pr - kw) // sw + 1
    m = torch.arange(n * oh * ow)
    img, rem = m // (oh * ow), m % (oh * ow)
    ih0, iw0 = (rem // ow) * sh - pt, (rem % ow) * sw - pl
    qi = q.to(torch.int64)
    acc = torch.zeros((m.numel(), co), dtype=torch.int64)
    rowsum = torch.zeros((m.numel(), co), dtype=torch.int64)
    for sl in range(c // ns):
        a = torch.zeros((m.numel(), nks * 128), dtype=torch.int64)
        for k in range(0, nks * 128, 16):
            tap = k // ns
            ci = sl * ns + k - tap * ns
            ih, iw = ih0 + tap // kw, iw0 + tap % kw
            ok = (tap < taps) & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w_sp)
            piece = qi[img, ih.clamp(0, h - 1), iw.clamp(0, w_sp - 1), ci:ci + 16]
            a[:, k:k + 16] = piece * ok[:, None]
        b = torch.zeros((ns, nks * 128), dtype=torch.int64)
        b[:, :taps * ns] = w_bd[sl * ns:(sl + 1) * ns].to(torch.int64)
        acc[:, sl * ns:(sl + 1) * ns] = a @ b.t()
        bins = a.reshape(m.numel(), -1, 8, ns // 8).sum(dim=(1, 3))  # (M, 8)
        per_group = bins.reshape(m.numel(), ns // cig, -1).sum(-1)  # (M, groups a slice)
        rowsum[:, sl * ns:(sl + 1) * ns] = per_group.repeat_interleave(cig, dim=1)
    shape = (n, oh, ow, co)
    out = acc.float().reshape(shape) + z * corr
    if not wz0:
        rows = (ih0[:, None] + torch.arange(kh) >= 0) & (ih0[:, None] + torch.arange(kh) < h)
        cols = (iw0[:, None] + torch.arange(kw) >= 0) & (iw0[:, None] + torch.arange(kw) < w_sp)
        count = (rows.sum(1) * cols.sum(1) * cig).float().reshape(n, oh, ow, 1)
        out = out + wz * rowsum.float().reshape(shape) + z * wz * count
    out = a_s * ws * out
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


@pytest.mark.parametrize("shape", WGMMA_SHAPES + tuple(
    (1, 9, 9, cig * g, cig * g, g, 3, 1 + i % 2, i % 3 != 0, "float32", "wgmma")
    for i, (cig, g) in enumerate(RESNEXT_WIDTHS)))
def test_wgmma_route_emulation_is_bit_equal_to_the_plain_version(shape):
    """The tensor-core route's decomposition, emulated on the CPU, bit for
    bit against the plain version at every test shape it takes and at each
    ResNeXt width (odd spatial size, strides 1 and 2, asymmetric weights)."""
    n, h, w, ci, co, g, k = shape[:7]
    args = _args(shape, "cpu", seed=sum(shape[:8]))
    assert tuple(args[13].shape) == (co, k * k * _grouped_slice(ci // g))  # the route's copy
    got = _emulate_wgmma_route(*args)
    want = qconv2d_grouped_int8_plain(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


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
    assert qconv2d_grouped_int8.route_launches == {"wgmma": 0, "dp4a": 0, shape[-1]: 1}
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
