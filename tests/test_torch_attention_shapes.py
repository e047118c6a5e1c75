"""The attention kernels K8 and K9 at the long sequences the JAX dispatch
sends them: ViT-B/16 at ``image_size`` 352, 384 and 416 (S = 485, 577 and
677 rows, padded to 488, 584 and 680), an f32 carry at S = 456, the
largest S the dispatch takes at E = 768 (776), and head dims 96 to 256.

On the CPU: the dispatch takes each of these shapes (``kernel_takes``) and
both kernels' shared memory fits a block at every S the dispatch takes, for
the ViT family's head dims (64, and 80 for ViT-H/14) and for head dims 96,
128 and 256 (E / H of 96/1, 512/4, 128/1, 256/2, 1024/8, 256/1, and 192/3,
384/6 at head dim 64); a head dim above 256 is refused by name with
ValueError; and the port's ``mha_fused_qkv_rows`` agrees with the JAX
function at S = 584 (E 768) and at S = 856, head dim 128 (E 512), bf16,
whose Pallas kernels run in interpret mode as the JAX package's own tests
run them.

Marked ``cuda``: K8 and K9 on the card at these shapes against their plain
versions, K8 within its tolerance (f32: rtol 1e-4 / atol 1e-5; bf16: two
bf16 ulps), K9 bit for bit.
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
    assert tattn._mha_rows_smem(s, E // H) <= tattn.SMEM_PER_BLOCK
    assert tattn._mha_rows_int8_smem(s, E // H) <= tattn.SMEM_PER_BLOCK


@pytest.mark.parametrize("e,h", [(768, 12), (1024, 16), (1280, 16), (512, 8),
                                 (96, 1), (512, 4), (128, 1), (256, 2), (1024, 8), (256, 1),
                                 (192, 3), (384, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_every_shape_the_dispatch_takes_fits_both_kernels(e, h, dtype, causal):
    """ViT-B, ViT-L, ViT-H/14 and CLIP's text tower widths, and head dims 96,
    128 and 256 (and 64 at E 192 and 384): at every S (a multiple of 8) that
    ``kernel_takes`` accepts, both kernels' tiles fit in a block's shared
    memory."""
    d = e // h
    taken = [s for s in range(8, 2048, 8)
             if tattn.kernel_takes(torch.empty((s, 3 * e), dtype=dtype), h, s, causal, s - 1)]
    assert taken
    for s in taken:
        assert tattn._mha_rows_smem(s, d) <= tattn.SMEM_PER_BLOCK, s
        assert tattn._mha_rows_int8_smem(s, d) <= tattn.SMEM_PER_BLOCK, s


def test_a_shape_above_the_shared_memory_is_refused_by_name():
    """Both kernels fit every S up to 1,248 (past the 1,240 the dispatch
    takes at its smallest widths) at head dims up to 256; a head dim above
    256 is refused by name, and so is a shape past a block's shared
    memory (S = 4,096 at head dim 256)."""
    for d in (64, 128, 256):
        for s in range(8, 1256, 8):
            assert tattn._mha_rows_smem(s, d) <= tattn.SMEM_PER_BLOCK, (s, d)
            assert tattn._mha_rows_int8_smem(s, d) <= tattn.SMEM_PER_BLOCK, (s, d)
    for what in ("mha_rows", "mha_rows_int8"):
        with pytest.raises(ValueError, match="head dim 264"):
            tattn._require_smem(what, getattr(tattn, f"_{what}_smem")(8, 264), 8, 264)
    assert tattn._mha_rows_smem(4096, 256) > tattn.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="232448"):
        tattn._require_smem("mha_rows", tattn._mha_rows_smem(4096, 256), 4096, 256)


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
    256, one head, bf16), against its plain version; at head dim 264 it
    raises ValueError naming the head dim before launch, with no
    fallback."""
    kernel, plain = getattr(tattn, name), getattr(tattn, name + "_plain")
    assert tattn.kernel_takes(torch.empty((largest, 768), dtype=torch.bfloat16), 1, largest,
                              False, largest - 3)
    qkv = _rows(1, largest, 256, seed=3, dtype=torch.bfloat16).cuda()
    got = kernel(qkv, 1, largest, False, torch.bfloat16, largest - 3)
    want = plain(qkv, 1, largest, False, torch.bfloat16, largest - 3)
    torch.cuda.synchronize()
    if name == "mha_rows":
        _assert_within_bf16_ulps(got, want, 2)
    else:
        assert torch.equal(got, want)
    big = _rows(1, 64, 264, seed=4, dtype=torch.bfloat16).cuda()
    reset_launch_counts()
    with pytest.raises(ValueError, match="head dim 264"):
        kernel(big, 1, 64, False, torch.bfloat16, 64)
    assert launch_counts()[name] == 0


# (E, H, S): head dim 128 at S 856 (E 512) and at the largest S the dispatch
# takes (1,072, E 128), head dim 256 (E 256, S 920), head dim 64 at S 1,160
# (E 64; K8's narrow tiles, K9's query groups)
WIDE_HEADS = [(512, 4, 856), (128, 1, 1072), (256, 1, 920), (64, 1, 1160)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,h,s", WIDE_HEADS)
@pytest.mark.parametrize("name", ["mha_rows", "mha_rows_int8"])
@pytest.mark.parametrize("causal", [False, True])
def test_cuda_kernels_at_head_dims_up_to_256(cuda_card, e, h, s, name, causal):
    """K8 within two bf16 ulps and K9 bit-equal to their plain versions at
    the shapes they used to refuse, through the dispatch; causal, at the
    largest S the dispatch takes up to that S (its causal mask takes VMEM
    of its own)."""
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
