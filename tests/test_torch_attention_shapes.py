"""The attention kernels K8 and K9 at the long sequences and wide heads the
JAX dispatch sends them: ViT-B/16 at ``image_size`` 352, 384 and 416 (S =
485, 577 and 677 rows, padded to 488, 584 and 680), an f32 carry at S =
456, the largest S the dispatch takes at E = 768 (776), and head dims 96 to
65,528.

On the CPU: the dispatch takes each of these shapes (``kernel_takes``) and
both kernels' shared memory, which no longer depends on S or the head dim,
fits a block at every S the dispatch takes, for the ViT family's head dims
(64, and 80 for ViT-H/14), for head dims 96 to 512 (E / H of 96/1, 512/4,
128/1, 256/2, 1024/8, 256/1, 320/1, 1024/2, and 192/3, 384/6 at head dim
64), for head dim 4,096 and for the widest heads the dispatch takes (S = 8:
49,144 in float32, 65,528 in bf16); a shape the kernels cannot take (a head
dim not a multiple of 8, more than 65,535 images) is refused by name with
ValueError; and the port's plain versions agree with the JAX package's
kernels at S = 584 (E 768), at S = 856, head dim 128 (E 512), bf16, and at
head dims 320 and 512 (f32 and bf16, causal or not), whose Pallas kernels
run in interpret mode as the JAX package's own tests run them (K9's body op
by op, bit for bit).

Marked ``cuda``: K8 and K9 on the card at these shapes against their plain
versions, K8 within its tolerance (f32: rtol 1e-4 / atol 1e-5; bf16: two
bf16 ulps), K9 bit for bit; both at the ViT main-path shapes, and without a
host synchronisation.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu_torch.ops import attention as tattn
from quantize_tpu_torch.ops import launch_counts, reset_launch_counts

torch.set_num_threads(2)

jattn = importlib.import_module("quantize_tpu.ops.pallas.attention")

E, H = 768, 12
# (S, valid rows, carry dtype, kernel): the shapes the JAX dispatch takes
# where the kernels used to refuse them for lack of shared memory
K8_SHAPES = [(488, 485, torch.bfloat16), (584, 577, torch.bfloat16),
             (680, 677, torch.bfloat16), (456, 453, torch.float32)]
K9_SHAPES = [(584, 577, torch.bfloat16), (776, 769, torch.bfloat16)]


def _rows(b, s, e, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(b * s, 3 * e)).astype(np.float32) * 2).to(dtype)


@pytest.mark.parametrize("s,valid,dtype", K8_SHAPES + K9_SHAPES)
def test_the_dispatch_takes_the_long_shapes(s, valid, dtype):
    qkv = torch.zeros((s, 3 * E), dtype=dtype)
    assert tattn.kernel_takes(qkv, H, s, False, valid)
    assert tattn._mha_rows_smem(s, E // H, qkv.element_size()) <= tattn.SMEM_PER_BLOCK
    assert tattn._mha_rows_int8_smem(s, E // H, qkv.element_size()) <= tattn.SMEM_PER_BLOCK


def _taken(e, h, dtype, causal, stop=2048):
    """Every S (a multiple of 8) below ``stop`` that ``kernel_takes``
    accepts at width E and H heads, with valid_len S - 1."""
    return [s for s in range(8, stop, 8)
            if tattn.kernel_takes(torch.empty((s, 3 * e), dtype=dtype), h, s, causal, s - 1)]


def _assert_both_fit(s, d, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    assert tattn._mha_rows_smem(s, d, item) <= tattn.SMEM_PER_BLOCK, (s, d)
    assert tattn._mha_rows_int8_smem(s, d, item) <= tattn.SMEM_PER_BLOCK, (s, d)


@pytest.mark.parametrize("e,h", [(768, 12), (1024, 16), (1280, 16), (512, 8),
                                 (96, 1), (512, 4), (128, 1), (256, 2), (1024, 8), (256, 1),
                                 (192, 3), (384, 6), (320, 1), (1024, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_every_shape_the_dispatch_takes_fits_both_kernels(e, h, dtype, causal):
    """ViT-B, ViT-L, ViT-H/14 and CLIP's text tower widths, and head dims 96,
    128, 256, 320 and 512 (and 64 at E 192 and 384): at every S (a multiple
    of 8) that ``kernel_takes`` accepts, both kernels' tiles fit in a
    block's shared memory."""
    taken = _taken(e, h, dtype, causal)
    assert taken
    for s in taken:
        _assert_both_fit(s, e // h, dtype)


def test_a_shape_above_the_shared_memory_is_refused_by_name():
    """No shape the dispatch admits is refused any more: both mirrors fit
    every S it takes at head dims 64, 128, 256, 320, 512 and 4,096 (one
    head), and at its widest heads, S = 8 at head dim 49,144 in float32 and
    65,528 in bf16 (a head 8 wider is not taken). K8's shared memory is one
    size whatever S and D; K9's streamed layout too, and its resident one
    stays within two blocks an SM. What the kernels cannot take is still
    refused by name before launch: a head dim that is not a multiple of 8,
    more than 65,535 images."""
    for d in (64, 128, 256, 320, 512, 4096):
        for dtype in (torch.float32, torch.bfloat16):
            taken = _taken(d, 1, dtype, False, stop=1400)
            assert taken, (d, dtype)
            for s in taken:
                _assert_both_fit(s, d, dtype)
    for dtype, widest in ((torch.float32, 49_144), (torch.bfloat16, 65_528)):
        assert _taken(widest, 1, dtype, False, stop=16) == [8]
        assert _taken(widest + 8, 1, dtype, False, stop=16) == []
        _assert_both_fit(8, widest, dtype)
    k8 = {(s, d, item): tattn._mha_rows_smem(s, d, item)
          for s in (8, 64, 72, 65_536) for d in (64, 128, 65_528) for item in (4, 2)}
    assert max(k8.values()) == 107_520
    assert {k8[(8, 64, 4)], k8[(64, 64, 2)], k8[(72, 64, 4)], k8[(72, 64, 2)],
            k8[(8, 128, 4)], k8[(65_536, 65_528, 2)]} == {70_656, 71_680, 106_496, 107_520,
                                                         87_040, 88_064}
    assert tattn._mha_rows_int8_layout(56, 64, 4) == (True, 111_712)
    assert tattn._mha_rows_int8_layout(200, 64, 4) == (False, tattn.K9_STREAMED_SMEM)
    assert tattn._mha_rows_int8_smem(4096, 65_528, 2) == tattn.K9_STREAMED_SMEM
    for what in ("mha_rows", "mha_rows_int8"):
        with pytest.raises(ValueError, match="head dim 12"):
            tattn._require_launchable(what, 2, 12, 2)
        with pytest.raises(ValueError, match="70000 images"):
            tattn._require_launchable(what, 70_000, 64, 1)
        tattn._require_launchable(what, 65_535, 65_528, 1)


def test_long_sequence_matches_jax_at_bf16():
    """One ViT-B/16 image at 384 x 384 (S = 577 padded to 584), bf16: the
    JAX function runs its Pallas ``_mha_rows_kernel`` in interpret mode, the
    port K8's plain version. Both round the same float32 values to bf16 at
    the same points, and the float32 sums over 577 keys differ only in
    order. An output that cancels to near zero keeps the absolute error of
    its sum, so each output is held to one bf16 ulp of the largest |output|
    of its (row, head) (seen: 0.0156 at most, one ulp of values in [2, 4))."""
    s, valid = 584, 577
    qkv = _rows(1, s, E, seed=584, dtype=torch.float32).numpy()
    want = np.asarray(jattn.mha_fused_qkv_rows(jnp.asarray(qkv).astype(jnp.bfloat16), H, s,
                                               valid_len=valid, int8_scores=False), np.float32)
    before = launch_counts()
    got = tattn.mha_fused_qkv_rows(torch.from_numpy(qkv).to(torch.bfloat16), H, s,
                                   valid_len=valid, int8_scores=False)
    assert launch_counts() == before and got.dtype == torch.bfloat16
    g = got.float().numpy()
    big = np.maximum(np.abs(g), np.abs(want)).reshape(s, H, E // H).max(-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(big.clip(1e-30))) - 7)
    assert np.isfinite(g).all()
    assert np.all(np.abs(g - want).reshape(s, H, E // H) <= ulp)


class _Ref:
    """A stand-in for a Pallas ref, so that a kernel body runs op by op."""

    def __init__(self, value=None, dtype=None):
        self.value, self.dtype = value, dtype

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        self.value = value


@pytest.mark.parametrize("int8_scores", [False, True])
def test_head_dim_128_matches_jax_at_bf16(int8_scores):
    """S = 856 at head dim 128 (E 512, 4 heads), bf16, a shape K9 and K8
    used to refuse, against the port's plain versions. K8: the JAX function
    (its Pallas kernel in interpret mode), each output within one bf16 ulp
    of the largest |output| of its (row, head), as above. K9: the JAX
    package's kernel body ``_mha_rows_int8_kernel`` run op by op, bit for
    bit; under ``jit`` XLA contracts ``acc * scale - max`` into one FMA,
    which moves exp's argument by a rounding and flips ex8 values (the
    accepted divergence "FMA contraction under jit"), so the port follows
    eager JAX here as everywhere."""
    e, h, s, valid = 512, 4, 856, 853
    d = e // h
    qkv = _rows(1, s, e, seed=856, dtype=torch.float32).numpy()
    xj = jnp.asarray(qkv).astype(jnp.bfloat16)
    if int8_scores:
        out = _Ref(dtype=jnp.bfloat16)
        jattn._mha_rows_int8_kernel(_Ref(xj), out, num_heads=h, head_dim=d, embed=e,
                                    scale=1.0 / (d ** 0.5), causal=False, valid_len=valid)
        want = np.asarray(out.value, np.float32)
    else:
        want = np.asarray(jattn.mha_fused_qkv_rows(xj, h, s, valid_len=valid, int8_scores=False),
                          np.float32)
    assert tattn.kernel_takes(torch.empty((s, 3 * e), dtype=torch.bfloat16), h, s, False, valid)
    before = launch_counts()
    got = tattn.mha_fused_qkv_rows(torch.from_numpy(qkv).to(torch.bfloat16), h, s,
                                   valid_len=valid, int8_scores=int8_scores)
    assert launch_counts() == before and got.dtype == torch.bfloat16
    g = got.float().numpy()
    assert np.isfinite(g).all()
    if int8_scores:
        np.testing.assert_array_equal(g, want)
    else:
        big = np.maximum(np.abs(g), np.abs(want)).reshape(s, h, d).max(-1, keepdims=True)
        ulp = np.exp2(np.floor(np.log2(big.clip(1e-30))) - 7)
        assert np.all(np.abs(g - want).reshape(s, h, d) <= ulp)


@pytest.mark.parametrize("d", [320, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8_scores", [False, True])
def test_wide_heads_match_jax(d, causal, dtype, int8_scores):
    """Head dims 320 and 512 (one head, two images, S = 16, valid 13), the
    widths the kernels used to refuse, against the JAX package. K8's plain
    version against the JAX function (its Pallas kernel in interpret
    mode): float32 within rtol 1e-5 / atol 1e-5 (summation order), bf16
    within one bf16 ulp of the largest |output| of its (row, head), as
    above. K9's plain version against ``_mha_rows_int8_kernel`` run op by op
    on each image, bit for bit."""
    b, s, valid = 2, 16, 13
    qkv = _rows(b, s, d, seed=d + causal, dtype=torch.float32).numpy() / 2
    xj = jnp.asarray(qkv).astype(dtype)
    if int8_scores:
        want = []
        for bi in range(b):
            out = _Ref(dtype=xj.dtype)
            jattn._mha_rows_int8_kernel(_Ref(xj[bi * s:(bi + 1) * s]), out, num_heads=1,
                                        head_dim=d, embed=d, scale=1.0 / (d ** 0.5),
                                        causal=causal, valid_len=valid)
            want.append(np.asarray(out.value, np.float32))
        want = np.concatenate(want)
    else:
        want = np.asarray(jattn.mha_fused_qkv_rows(xj, 1, s, causal=causal, valid_len=valid,
                                                   int8_scores=False), np.float32)
    xt = torch.from_numpy(qkv).to(getattr(torch, dtype))
    assert tattn.kernel_takes(xt, 1, s, causal, valid)
    before = launch_counts()
    got = tattn.mha_fused_qkv_rows(xt, 1, s, causal=causal, valid_len=valid,
                                   int8_scores=int8_scores)
    assert launch_counts() == before and got.dtype == xt.dtype
    g = got.float().numpy()
    assert np.isfinite(g).all()
    if int8_scores:
        np.testing.assert_array_equal(g, want)
    elif dtype == "float32":
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)
    else:
        big = np.maximum(np.abs(g), np.abs(want)).max(-1, keepdims=True)
        ulp = np.exp2(np.floor(np.log2(big.clip(1e-30))) - 7)
        assert np.all(np.abs(g - want) <= ulp)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the GPU machine)")


def _assert_within_bf16_ulps(got, want, ulps):
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
    assert bool(((g - w).abs() <= ulps * ulp).all()), float((g - w).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("s,valid,dtype", K8_SHAPES)
def test_cuda_k8_takes_the_long_shapes(cuda_card, s, valid, dtype):
    qkv = _rows(2, s, E, seed=s, dtype=dtype).cuda()
    reset_launch_counts()
    got = tattn.mha_fused_qkv_rows(qkv, H, s, valid_len=valid, int8_scores=False)
    want = tattn.mha_rows_plain(qkv, H, s, False, dtype, valid)
    torch.cuda.synchronize()
    assert launch_counts()["mha_rows"] == 1
    assert bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        _assert_within_bf16_ulps(got, want, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("s,valid,dtype", K9_SHAPES)
def test_cuda_k9_takes_the_long_shapes(cuda_card, s, valid, dtype):
    qkv = _rows(2, s, E, seed=s + 1, dtype=dtype).cuda()
    reset_launch_counts()
    got = tattn.mha_fused_qkv_rows(qkv, H, s, valid_len=valid, int8_scores=True)
    want = tattn.mha_rows_int8_plain(qkv, H, s, False, dtype, valid)
    torch.cuda.synchronize()
    assert launch_counts()["mha_rows_int8"] == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,largest", [("mha_rows", 920), ("mha_rows_int8", 920)])
def test_cuda_kernels_at_their_largest_s_and_refusal_past_it(cuda_card, name, largest):
    """Each kernel at the largest S the dispatch takes at head dim 256 (E
    256, one head, bf16), and at head dim 264, which both used to refuse
    before launch, against its plain version; a head dim that is not a
    multiple of 8 still raises ValueError naming it before launch, with no
    fallback."""
    kernel, plain = getattr(tattn, name), getattr(tattn, name + "_plain")
    assert tattn.kernel_takes(torch.empty((largest, 768), dtype=torch.bfloat16), 1, largest,
                              False, largest - 3)
    for s, d in ((largest, 256), (64, 264)):
        qkv = _rows(1, s, d, seed=3 + d, dtype=torch.bfloat16).cuda()
        reset_launch_counts()
        got = kernel(qkv, 1, s, False, torch.bfloat16, s - 3)
        want = plain(qkv, 1, s, False, torch.bfloat16, s - 3)
        torch.cuda.synchronize()
        assert launch_counts()[name] == 1
        if name == "mha_rows":
            _assert_within_bf16_ulps(got, want, 2)
        else:
            assert torch.equal(got, want)
    odd = _rows(1, 64, 12, seed=4, dtype=torch.bfloat16).cuda()
    reset_launch_counts()
    with pytest.raises(ValueError, match="head dim 12"):
        kernel(odd, 1, 64, False, torch.bfloat16, 64)
    assert launch_counts()[name] == 0


# (E, H, S): head dim 128 at S 856 (E 512) and at the largest S the dispatch
# takes (1,072, E 128), head dim 256 (E 256, S 920), head dim 64 at S 1,160
# (E 64), head dims 320 and 512 (E 320, one head; E 1024, two) and the
# widest head the dispatch takes in bf16, 65,528 at S = 8
WIDE_HEADS = [(512, 4, 856), (128, 1, 1072), (256, 1, 920), (64, 1, 1160), (320, 1, 600),
              (1024, 2, 400), (65528, 1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,h,s", WIDE_HEADS)
@pytest.mark.parametrize("name", ["mha_rows", "mha_rows_int8"])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_kernels_at_head_dims_up_to_256(cuda_card, e, h, s, name, causal):
    """K8 within two bf16 ulps and K9 bit-equal to their plain versions at
    the shapes they used to refuse (head dims 96 to 65,528), through the
    dispatch; causal, at the largest S the dispatch takes up to that S (its
    causal mask takes VMEM of its own)."""
    s = max(t for t in range(8, s + 1, 8) if tattn.kernel_takes(
        torch.empty((t, 3 * e), dtype=torch.bfloat16), h, t, causal, t - 3))
    qkv = _rows(2, s, e, seed=s + e, dtype=torch.bfloat16).cuda()
    reset_launch_counts()
    got = tattn.mha_fused_qkv_rows(qkv, h, s, causal=causal, valid_len=s - 3,
                                   int8_scores=name == "mha_rows_int8")
    want = getattr(tattn, name + "_plain")(qkv, h, s, causal, torch.bfloat16, s - 3)
    torch.cuda.synchronize()
    assert launch_counts()[name] == 1
    assert bool(torch.isfinite(got.float()).all())
    if name == "mha_rows":
        _assert_within_bf16_ulps(got, want, 2)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k9_at_the_vit_b32_shape_bit_for_bit(cuda_card, dtype):
    """K9 where ViT-B/32's int8-scores forward runs it (256 images, S = 50
    padded to 56, 12 heads of 64; the resident layout): bit-equal to its
    plain version, with the pad rows in the absmax."""
    s, valid = 56, 50
    assert tattn._mha_rows_int8_layout(s, 64, torch.empty((), dtype=dtype).element_size())[0]
    qkv = _rows(256, s, E, seed=56, dtype=dtype).cuda()
    reset_launch_counts()
    got = tattn.mha_fused_qkv_rows(qkv, H, s, valid_len=valid, int8_scores=True)
    want = tattn.mha_rows_int8_plain(qkv, H, s, False, dtype, valid)
    torch.cuda.synchronize()
    assert launch_counts()["mha_rows_int8"] == 1 and tattn.mha_rows_int8.absmax_launches == 0
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k8_at_the_vit_b16_shape(cuda_card, dtype):
    """K8 where ViT-B/16's forward runs it (128 images, S = 197 padded to
    200, 12 heads of 64) within the unchanged check: f32 rtol 1e-4 / atol
    1e-5, bf16 two ulps."""
    s, valid = 200, 197
    qkv = _rows(128, s, E, seed=200, dtype=dtype).cuda()
    reset_launch_counts()
    got = tattn.mha_fused_qkv_rows(qkv, H, s, valid_len=valid, int8_scores=False)
    want = tattn.mha_rows_plain(qkv, H, s, False, dtype, valid)
    torch.cuda.synchronize()
    assert launch_counts()["mha_rows"] == 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        _assert_within_bf16_ulps(got, want, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("name,s,d", [("mha_rows", 200, 64), ("mha_rows", 16, 320),
                                      ("mha_rows_int8", 56, 64), ("mha_rows_int8", 200, 64)])
def test_cuda_attention_kernels_do_not_sync_the_host(cuda_card, name, s, d):
    """K8, and K9 in both of its layouts (resident at S = 56, the absmax
    pre-pass and the streamed blocks at S = 200), launch without a host
    synchronisation: the scales stay on the device."""
    qkv = _rows(2, s, 2 * d, seed=s, dtype=torch.float32).cuda()
    kernel = getattr(tattn, name)
    kernel(qkv, 2, s, False, torch.float32, s - 3)  # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = kernel(qkv, 2, s, False, torch.float32, s - 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(8, 4096), (64, 4096), (8, 8192), (8, 49144)])
def test_cuda_k8_float32_scores_either_side_of_the_chain_limit(cuda_card, s, d):
    """K8 in float32 at one head of 4,096 (one fmaf chain a score, the order
    of the plain version's float32 product) and of 8,192 and 49,144 (chunk
    sums added with Kahan compensation, where that product splits the sum),
    S = 8 and 64, within the unchanged check: rtol 1e-4 / atol 1e-5."""
    assert tattn.kernel_takes(torch.empty((s, 3 * d)), 1, s, False, s - 3)
    qkv = _rows(4, s, d, seed=s + d, dtype=torch.float32).cuda()
    got = tattn.mha_rows(qkv, 1, s, False, torch.float32, s - 3)
    want = tattn.mha_rows_plain(qkv, 1, s, False, torch.float32, s - 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
