"""Kernel K1's two routes (``csrc/w8a8_gemm.cu``): the W8A8 matmul.

The route is chosen from the shape before launch (``_w8a8_route``): the
warp-specialized ``wgmma`` kernel over the weight's K-major copy
``w_kmajor``, which ``QuantDense`` makes once when its int8 weight is set,
where K is a multiple of 16; the ``mma.sync`` kernel for every other K. On
the ``wgmma`` route a cluster of S CTAs splits the K loop of each output
tile where the output has few tiles (``_w8a8_split``). On the CPU every
route runs the plain version, so all results here are bit-equal; the tests
marked ``cuda`` hold each route and each S against it on the card (run
there with ``--noconftest``: this file imports no JAX).
"""
import numpy as np
import pytest
import torch

import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert
from quantize_tpu_torch.nn.attention import fused_w8_operands
from quantize_tpu_torch.nn.layers import LayerQuantCfg, QuantDense
from quantize_tpu_torch.nn.variables import collections
from quantize_tpu_torch.ops import reset_launch_counts
from quantize_tpu_torch.ops.qmatmul import (_w8a8_route, _w8a8_split, kmajor_packed,
                                            quant_matmul_w8a8, w8a8_gemm, w8a8_gemm_plain)

torch.set_num_threads(2)

H100_SMS = 132

# (M, K, N) of the main path and of the W8A8 layers the port serves next:
# ResNet-50's fc at batch 256; ViT-B/16's fused qkv, fc1, fc2 and out-
# projection at batch 128 (M = 25,600); one image through the head
MAIN_SHAPES = [(256, 2048, 1000), (25600, 768, 2304), (25600, 768, 3072), (25600, 3072, 768),
               (25600, 768, 768), (1, 2048, 1000)]


@pytest.mark.parametrize("m,k,n", MAIN_SHAPES + [(7, 48, 28), (200, 16, 1000)])
def test_main_path_shapes_take_the_wgmma_route(m, k, n):
    """Any M and N (TMA zero-fills the tiles past them); K a multiple of 16."""
    assert _w8a8_route(k) == "wgmma"
    assert _w8a8_route(k, aligned=False) == "mma_sync"


@pytest.mark.parametrize("k", [1, 8, 40, 100, 1000, 2056 + 4, 131072, 262144])
def test_other_k_takes_the_mma_sync_route(k):
    assert (k % 16 or k >= 1 << 17) and _w8a8_route(k) == "mma_sync"


@pytest.mark.parametrize("m,n,k,sms,split", [
    (256, 1000, 2048, H100_SMS, 4),    # ResNet-50's head: 16 tiles, 16 K stages
    (1, 1000, 2048, H100_SMS, 4),      # one image: 8 tiles
    (128, 1000, 4096, H100_SMS, 8),    # 8 tiles, 32 stages: the largest cluster
    (512, 1000, 1024, H100_SMS, 2),    # 32 tiles, 8 stages: 4 a CTA at S = 2
    (25600, 2304, 768, H100_SMS, 1),   # ViT-B/16 at batch 128: 3,600 tiles
    (25600, 768, 3072, H100_SMS, 1),
    (128, 768, 768, H100_SMS, 1),      # 6 stages: too few to split
    (256, 1000, 2048, 16, 1),          # a card of 16 SMs is full already
    (256, 1000, 2048, 64, 4),
])
def test_split_fills_the_card_and_keeps_four_stages_a_cta(m, n, k, sms, split):
    assert _w8a8_split(m, n, k, sms) == split
    tiles, nk = -(-m // 128) * -(-n // 128), -(-k // 128)
    assert split == 1 or (tiles * split <= sms and nk // split >= 4)


def _operands(m, k, n, wz0, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    w_zero = np.zeros(n) if wz0 else rng.normal(size=n)
    return [q, torch.tensor(131.5), torch.tensor(0.0123), w, w.sum(0, dtype=torch.int32),
            torch.from_numpy(rng.random(n).astype(np.float32) * 0.01),
            torch.from_numpy(w_zero.astype(np.float32)),
            torch.from_numpy(rng.normal(size=n).astype(np.float32))]


@pytest.mark.parametrize("m,k,n", [(5, 96, 40), (7, 40, 28), (1, 2048, 1000)])
@pytest.mark.parametrize("wz0", [True, False])
def test_the_kmajor_copy_alone_gives_the_same_product(m, k, n, wz0):
    """The wrapper and the plain version take the weight as ``w_int``, as
    its K-major copy alone (what the fused q/k/v hands the wgmma route), or
    as both: bit-equal."""
    args = _operands(m, k, n, wz0)
    w_km = kmajor_packed(args[3])
    assert w_km.shape == (n, k) and w_km.is_contiguous() and torch.equal(w_km, args[3].t())
    want = w8a8_gemm_plain(*args, wz0)
    only_km = args[:3] + [None] + args[4:]
    for got in (w8a8_gemm(*args, wz0), w8a8_gemm(*args, wz0, w_km),
                w8a8_gemm(*only_km, wz0, w_km), w8a8_gemm_plain(*only_km, wz0, w_km)):
        assert torch.equal(got, want)
    x = torch.randn(m, k)
    a = (torch.tensor(0.05), torch.tensor(-3.0), 0, 255)
    assert torch.equal(quant_matmul_w8a8(x, *a, None, *args[5:8], None, wz0, w_km=w_km),
                       quant_matmul_w8a8(x, *a, args[3], *args[5:8], None, wz0))
    with pytest.raises(ValueError, match="needs w_int or its K-major copy"):
        w8a8_gemm(*only_km, wz0)


def test_fused_qkv_operands_follow_the_route():
    """The fused q/k/v weight: on the wgmma route the three K-major copies
    along dim 0, which is the K-major copy of the three weights along dim
    1; elsewhere the weights along dim 1 alone."""
    bufs = []
    for seed in range(3):
        w = _operands(2, 96, 40 + 8 * seed, True, seed)[3]
        bufs.append({"w_int": w, "w_kmajor": kmajor_packed(w)})
    cat = torch.cat([b["w_int"] for b in bufs], dim=1)
    w, w_km = fused_w8_operands(bufs, torch.device("cuda"), 96)
    assert w is None and w_km.is_contiguous() and torch.equal(w_km, kmajor_packed(cat))
    w, w_km = fused_w8_operands(bufs, torch.device("cpu"), 96)
    assert w_km is None and torch.equal(w, cat)
    # K = 40: the mma.sync route reads the weights as they are
    w, w_km = fused_w8_operands(bufs, torch.device("cuda"), 40)
    assert w_km is None and torch.equal(w, cat)


_W8A8 = LayerQuantCfg(
    weight={"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
            "range": {"name": "minmax"}},
    activation={"n_bits": 8, "symmetric": False, "granularity": "layer",
                "range": {"name": "minmax"}})


def _packed_dense(k=48, n=24, seed=3):
    g = torch.Generator().manual_seed(seed)
    dense = QuantDense(k, n, quant=_W8A8, device="cpu")
    dense.init_params(g)
    x = torch.randn((6, k), generator=g)
    with torch.no_grad():
        dense(x, mode="calibrate")
        dense(x, mode="pack")
    return dense, x


def test_quant_dense_makes_the_kmajor_copy_when_packed_and_when_loaded():
    """A packed W8A8 QuantDense makes ``w_kmajor`` once, when its int8
    weight is packed or loaded from the JAX layout, as a buffer outside the
    deploy variables and the state dict; a new weight replaces it."""
    dense, x = _packed_dense()
    w_int = dense.get_var("packed", "w_int")
    assert torch.equal(dense.w_kmajor, w_int.t().contiguous()) and dense.w_kmajor.is_contiguous()
    assert "w_kmajor" not in dense.state_dict()
    assert not any("kmajor" in key for col in collections(dense).values() for key in col)
    made = dense.w_kmajor
    with torch.no_grad():
        out = dense(x, mode="packed")
    assert dense.w_kmajor is made

    fresh = QuantDense(48, 24, quant=_W8A8, device="cpu")
    convert.from_jax_variables(fresh, convert.to_numpy(dense))
    assert torch.equal(fresh.w_kmajor, w_int.t().contiguous())
    assert "w_kmajor" not in fresh.state_dict()
    with torch.no_grad():
        assert torch.equal(fresh(x, mode="packed"), out)
    dense.put_var("packed", "w_int", w_int.neg())
    assert torch.equal(dense.w_kmajor, w_int.neg().t().contiguous())


class _Head(torch.nn.Module):
    def __init__(self, fc):
        super().__init__()
        self.fc = fc

    def forward(self, x, mode="fp32"):
        return self.fc(x, mode=mode)


def test_deploy_variables_hold_no_kmajor_copy():
    dense, x = _packed_dense()
    deploy = qtt.pack_model(_Head(dense), x, device="cpu")
    assert "fc/w_int" in deploy["packed"]
    assert not any("kmajor" in key for col in deploy.values() for key in col)


def test_weight_only_dense_makes_no_copy():
    """No activation quantize, no K1: the weight-only dense keeps no copy."""
    quant = LayerQuantCfg(weight=dict(_W8A8.weight), activation={"n_bits": 32})
    dense = QuantDense(48, 24, quant=quant, device="cpu")
    dense.put_var("packed", "w_int", torch.zeros((48, 24), dtype=torch.int8))
    assert not hasattr(dense, "w_kmajor")


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the GPU machine)")


# (M, K, N): every split S of the card (ResNet-50's head S = 4, one image
# S = 4, K = 4096 S = 8, M = 512 S = 2, the rest S = 1), ragged M and N
# (N = 28, 1000; M = 1, 333), K off the 128-byte stage (48, 784) and the
# ViT-B/16 W8A8 shapes at a smaller M
WGMMA_SHAPES = [(256, 2048, 1000), (1, 2048, 1000), (128, 4096, 1000), (512, 1024, 1000),
                (333, 48, 28), (200, 784, 1000), (4096, 768, 2304), (4096, 3072, 768),
                (2048, 768, 768), (130, 2048, 130)]


@pytest.mark.cuda
def test_cuda_shapes_cover_every_split(cuda_card):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert {_w8a8_split(m, n, k, sms) for m, k, n in WGMMA_SHAPES} == {1, 2, 4, 8}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
@pytest.mark.parametrize("wz0", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_cuda_wgmma_route_is_bit_equal_to_the_plain_version(cuda_card, shape, wz0, with_bias):
    m, k, n = shape
    args = [t.cuda() for t in _operands(m, k, n, wz0, seed=k + n)]
    if not with_bias:
        args[7] = None
    w_km = kmajor_packed(args[3])
    reset_launch_counts()
    got = w8a8_gemm(*args, wz0, w_km)
    want = w8a8_gemm_plain(*args, wz0)
    torch.cuda.synchronize()
    assert w8a8_gemm.route_launches == {"wgmma": 1, "mma_sync": 0}
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("given", ["w_int only", "w_km only", "misaligned A", "K = 40"])
def test_cuda_routes_by_shape_and_alignment(cuda_card, given):
    """``w_int`` alone (the wrapper makes the copy) or the copy alone take the
    wgmma route; an A that is not 16-byte aligned, or K = 40, the mma.sync
    route (the wrapper makes the (K, N) weight from the copy); every one
    bit-equal."""
    m, k, n = (200, 40, 1000) if given == "K = 40" else (200, 768, 1000)
    args = [t.cuda() for t in _operands(m, k, n, False, seed=1)]
    w_km = kmajor_packed(args[3])
    want = w8a8_gemm_plain(*args, False)
    if given == "misaligned A":
        buf = torch.empty(m * k + 1, dtype=torch.int8, device="cuda")
        args[0] = buf[1:].view(m, k).copy_(args[0])
    if given != "w_int only":
        args[3] = None
    reset_launch_counts()
    got = w8a8_gemm(*args, False, None if given == "w_int only" else w_km)
    torch.cuda.synchronize()
    route = "mma_sync" if given in ("misaligned A", "K = 40") else "wgmma"
    assert w8a8_gemm.route_launches == {"wgmma": 0, "mma_sync": 0, route: 1}
    assert torch.equal(got, want)
