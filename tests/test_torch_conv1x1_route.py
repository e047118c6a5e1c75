"""Kernel K2's two routes (``csrc/conv1x1_residual.cu``), on the CPU.

The route is chosen from the shape before launch (``_conv1x1_route``): the
persistent ``wgmma`` kernel, which reads the weight's K-major copy
``QuantConv.w_kmajor``, where K is a multiple of 16 below 2^17, the
residual's and the output's rows are multiples of 16 bytes and the
operands are 16-byte aligned; the ``mma.sync`` kernel for every other
shape. These tests hold the choice, the wgmma kernel's shared-memory
mirror, the copy and the packed ResNet's hand-over of it; the kernels
themselves run on the card (the ``cuda`` tests of
``tests/test_torch_package.py``). On the CPU every route runs the plain
version, so all results here are bit-equal.
"""
import numpy as np
import pytest
import torch

import quantize_tpu_torch as qtt
import quantize_tpu_torch.ops.qconv1x1 as qconv1x1
from quantize_tpu_torch.models.resnet import ResNet
from quantize_tpu_torch.ops.attention import SMEM_PER_BLOCK
from quantize_tpu_torch.ops.qconv import kmajor_weight
from quantize_tpu_torch.ops.qconv1x1 import (_conv1x1_route, _conv1x1_smem, conv1x1_residual,
                                             conv1x1_residual_gemm)

torch.set_num_threads(2)


@pytest.mark.parametrize("k,n,aligned,itemsize,route", [
    (16, 256, True, 4, "wgmma"),       # the shortest K the route takes
    (48, 256, True, 4, "wgmma"),       # a multiple of 16, not of 32
    (64, 256, True, 4, "wgmma"),       # ResNet-50's layer1 tails
    (2048, 2048, True, 2, "wgmma"),    # the longest K loop of the family's 1x1 convs
    (131056, 256, True, 4, "wgmma"),   # the last K below 2^17
    (1024, 1000, True, 4, "wgmma"),    # N = 1000: 4,000-byte rows
    (1024, 1000, True, 2, "wgmma"),    # 2,000-byte rows in bf16
    (64, 28, True, 4, "wgmma"),        # N = 4 x 7 in f32: 112-byte rows
    (63, 256, True, 4, "mma_sync"),    # odd K
    (40, 256, True, 4, "mma_sync"),    # K not a multiple of 16
    (131072, 256, True, 4, "mma_sync"),  # K = 2^17: the int32 sums could overflow
    (0, 256, True, 4, "mma_sync"),
    (64, 28, True, 2, "mma_sync"),     # N = 4 x 7 in bf16: 56-byte rows
    (64, 1004, True, 2, "mma_sync"),   # bf16 with N not a multiple of 8
    (64, 1003, True, 4, "mma_sync"),   # f32 with N not a multiple of 4
    (64, 256, False, 4, "mma_sync"),   # a misaligned operand
])
def test_route_at_its_boundaries(k, n, aligned, itemsize, route):
    assert _conv1x1_route(k, n, aligned, itemsize) == route


@pytest.mark.parametrize("res,out,stages", [(4, 4, 2), (2, 2, 4), (4, 2, 2), (2, 4, 2)])
def test_wgmma_shared_memory_fits_and_depends_on_neither_m_nor_k(res, out, stages):
    """``Tile::SMEM``: a ring of 32 KB stages (16 KB of A, 16 KB of W), two
    buffers of a 128 x 128 tile in the wider dtype, barriers and columns,
    1 KB of slack; no argument for M, N or K exists."""
    got_stages, smem = _conv1x1_smem(res, out)
    assert got_stages == stages
    assert smem == stages * 32768 + 2 * 128 * 128 * max(res, out) + 128 + 3072 + 1024
    assert smem <= SMEM_PER_BLOCK == 227 * 1024


@pytest.mark.parametrize("k,co", [(16, 8), (64, 256), (512, 2048), (2048, 64)])
def test_kmajor_weight_of_a_1x1_kernel_is_the_transposed_matrix(k, co):
    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.integers(-127, 128, (1, 1, k, co), dtype=np.int8))
    w_km = kmajor_weight(w)
    assert w_km.is_contiguous() and torch.equal(w_km, w.reshape(k, co).t())


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return [q, torch.tensor(-57.25), torch.tensor(0.0123), w, w.sum(0, dtype=torch.int32),
            f(rng.random(n) * 0.01), f(rng.normal(size=n)), f(rng.normal(size=(m, n)) * 4),
            True, torch.float32]


@pytest.mark.parametrize("m,k,n", [(147, 64, 256), (30, 24, 28), (49, 512, 1000)])
def test_the_kmajor_copy_beside_the_weight_gives_the_same_output(m, k, n):
    """The wrapper takes the K-major copy beside the (K, N) weight (for K off
    the 16 grid kmajor_weight's copy carries zero columns past K, and that
    shape takes the mma.sync route, which reads the weight)."""
    args = _operands(m, k, n)
    w_km = kmajor_weight(args[3].reshape(1, 1, k, n))
    assert w_km.shape == (n, -(-k // 16) * 16)
    assert torch.equal(conv1x1_residual_gemm(*args, w_km), conv1x1_residual_gemm(*args))


def test_packed_resnet_hands_its_kmajor_copy_to_k2(monkeypatch):
    """A packed forward with the fused residual tail gives K2 every tail
    conv's K-major copy (the buffer QuantConv made at pack time, itself, not
    a new one) beside its (K, N) weight, positionally; the logits do not
    change."""
    cfg = {"default": {
        "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
                   "range": {"name": "minmax"}},
        "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                       "range": {"name": "minmax"}},
        "bn_folding": True}}
    model = ResNet(stage_sizes=[1, 1, 1, 1], bottleneck=True, num_classes=10,
                   ctx=qtt.QuantCtx(cfg), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    qtt.init_model(model, x, seed=0, device="cpu")
    qtt.calibrate_model(model, [x], device="cpu")
    qtt.pack_model(model, x, device="cpu")
    tails = [getattr(model, name).conv3 for name in model.block_names]
    calls = []
    orig = qconv1x1.conv1x1_residual_gemm

    def recorder(*args):
        calls.append(args)
        return orig(*args)

    with torch.no_grad(), qtt.fused_residual(True):
        want = model(x, mode="packed")
        monkeypatch.setattr(qconv1x1, "conv1x1_residual_gemm", recorder)
        got = model(x, mode="packed")
    assert len(calls) == len(tails) == 4
    for args, conv in zip(calls, tails):
        assert len(args) == 11 and args[10] is conv.w_kmajor
        k, n = args[3].shape
        assert torch.equal(args[10], args[3].t()) and args[10].shape == (n, k)
    assert torch.equal(got, want)


def test_public_conv1x1_residual_passes_the_copy_through(monkeypatch):
    args = _operands(2 * 3 * 5, 32, 48)
    q, z, s, w, cs, ws, b, res = args[:8]
    w_km = kmajor_weight(w.reshape(1, 1, 32, 48))
    seen = []
    orig = qconv1x1.conv1x1_residual_gemm
    monkeypatch.setattr(qconv1x1, "conv1x1_residual_gemm",
                        lambda *a: seen.append(a[10]) or orig(*a))
    got = conv1x1_residual(q.reshape(2, 3, 5, 32), z, s, w.reshape(1, 1, 32, 48), ws, b,
                           res.reshape(2, 3, 5, 48), w_km=w_km)
    assert len(seen) == 1 and seen[0] is w_km
    assert torch.equal(got.reshape(30, 48), orig(*args))
