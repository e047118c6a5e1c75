"""The attention kernels K8 and K9 at the long sequences the JAX dispatch
sends them: ViT-B/16 at ``image_size`` 352, 384 and 416 (S = 485, 577 and
677 rows, padded to 488, 584 and 680), an f32 carry at S = 456 and the
largest S the dispatch takes at E = 768 (776).

On the CPU: the dispatch takes each of these shapes (``kernel_takes``) and
both kernels' shared memory fits a block, for the ViT family's head dims
(64, and 80 for ViT-H/14) at every S the dispatch takes; a shape that does
not fit is refused with ValueError; and the port's ``mha_fused_qkv_rows``
agrees with the JAX function at S = 584, bf16, whose Pallas kernel runs in
interpret mode as the JAX package's own tests run it.

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


@pytest.mark.parametrize("e,h", [(768, 12), (1024, 16), (1280, 16), (512, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_every_shape_the_dispatch_takes_fits_both_kernels(e, h, dtype, causal):
    """ViT-B, ViT-L, ViT-H/14 and CLIP's text tower widths: at every S (a
    multiple of 8) that ``kernel_takes`` accepts, both kernels' tiles fit in
    a block's shared memory."""
    d = e // h
    taken = [s for s in range(8, 2048, 8)
             if tattn.kernel_takes(torch.zeros((s, 3 * e), dtype=dtype), h, s, causal, s - 1)]
    assert taken
    for s in taken:
        assert tattn._mha_rows_smem(s, d) <= tattn.SMEM_PER_BLOCK, s
        assert tattn._mha_rows_int8_smem(s, d) <= tattn.SMEM_PER_BLOCK, s


def test_a_shape_above_the_shared_memory_is_refused_by_name():
    """S = 1,128 at head dim 64 is past K8's tiles and S = 936 past K9's
    (the dispatch sends such S only at E = 64 or 128): the refusal names
    the limit."""
    assert tattn._mha_rows_smem(1120, 64) <= tattn.SMEM_PER_BLOCK < tattn._mha_rows_smem(1128, 64)
    assert (tattn._mha_rows_int8_smem(928, 64) <= tattn.SMEM_PER_BLOCK
            < tattn._mha_rows_int8_smem(936, 64))
    with pytest.raises(ValueError, match="232448"):
        tattn._require_smem("mha_rows", tattn._mha_rows_smem(1128, 64), 1128, 64)


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
@pytest.mark.parametrize("name,largest", [("mha_rows", 1120), ("mha_rows_int8", 928)])
def test_cuda_kernels_at_their_largest_s_and_refusal_past_it(cuda_card, name, largest):
    """Each kernel at the largest S its tiles take at head dim 64 (one
    head), against its plain version; eight rows more and it raises
    ValueError before launch, with no fallback."""
    kernel, plain = getattr(tattn, name), getattr(tattn, name + "_plain")
    assert getattr(tattn, f"_{name}_smem")(largest + 8, 64) > tattn.SMEM_PER_BLOCK
    qkv = _rows(1, largest, 64, seed=3, dtype=torch.bfloat16).cuda()
    got = kernel(qkv, 1, largest, False, torch.bfloat16, largest - 3)
    want = plain(qkv, 1, largest, False, torch.bfloat16, largest - 3)
    torch.cuda.synchronize()
    if name == "mha_rows":
        _assert_within_bf16_ulps(got, want, 2)
    else:
        assert torch.equal(got, want)
    big = _rows(1, largest + 8, 64, seed=4, dtype=torch.bfloat16).cuda()
    reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        kernel(big, 1, largest + 8, False, torch.bfloat16, largest + 8)
    assert launch_counts()[name] == 0
