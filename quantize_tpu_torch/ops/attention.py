"""Fused multi-head attention for packed transformer inference: kernels K8
and K9.

PyTorch counterpart of ``quantize_tpu/ops/pallas/attention.py``. The packed
attention middle reads the fused q/k/v projection output as 2-D
``(B*S, 3E)`` rows (q of head h at lanes ``[h*d, (h+1)*d)``, k at
``E + h*d``, v at ``2E + h*d``) and writes ``(B*S, E)`` rows: no reshape to
4-D and no (S, S) score tensor in device memory.

:func:`mha_fused_qkv_rows` dispatches as the JAX function does: a head dim
or a sequence length that is not a multiple of 8, or a block above the
Pallas kernel's VMEM budget, goes to :func:`mha_oracle_rows` (JAX's
``_mha_ref``: float32 einsums and an exact softmax); every other shape to
K8, or to K9 with ``int8_scores`` (default: ``QTPU_ATTN_INT8=1`` in the
environment, read at call time).

Both kernels take every shape the dispatch sends them, in float32 and
bf16, causal or not, at every head dim it admits (a multiple of 8, up to
65,528 at S = 8): their shared memory does not depend on S or the head dim
(:func:`_mha_rows_smem`, :func:`_mha_rows_int8_layout` mirror the kernels'
layouts). Both stream keys in chunks of 64 through tiles of 64 x 64, run
QK^T in head-dim chunks of 64 and split a wide head across blocks by output
columns (K8 above head dim 128, K9 above 64). K9 keeps heads resident in
shared memory where two blocks fit an SM (:data:`K9_RESIDENT_LIMIT`; ViT-B/32's
S = 56 at head dim 64) and otherwise launches an absmax pre-pass before its
streamed blocks. A shape the kernels cannot take (a head dim not a multiple
of 8, more than 65,535 images or heads) raises ValueError naming it before
launch; the dispatch sends none.

* K8, :func:`mha_rows` (``csrc/mha_rows.cu``; :func:`mha_rows_plain` on CPU
  tensors), follows the Pallas ``_mha_rows_kernel`` exactly: q scaled in
  float32 and rounded to the product dtype (bf16 for a bf16 input),
  f32-summed scores, masking by ``min(sc, -1e30)``, the row max floored at
  -80, the normalizer floored at 1e-37, the exp weights rounded to the
  product dtype before the AV product while the normalizer sums them in
  float32, and ``1/sum`` applied to the (S, D) output. Each product is an
  fmaf chain on the CUDA cores in the plain version's order (head dims for
  a score, keys for an output): the tensor cores' sums, in another order,
  flip bf16 roundings of the exp weights, and TF32 misses the float32
  check.
* K9, :func:`mha_rows_int8` (``csrc/mha_rows_int8.cu``;
  :func:`mha_rows_int8_plain` on CPU tensors), follows the Pallas
  ``_mha_rows_int8_kernel``: q, k and v quantized to int8 with one
  symmetric absmax scale per (image, head) taken over all S rows of the
  padded block, pad rows included; int8 QK^T and AV with exact integer
  sums; the exp weights quantized to [0, 127] and their integer sum as the
  normalizer.
"""
from __future__ import annotations

import os

import torch

from . import _build, _cost

# the shared memory one block may use on the H100 (227 KB)
SMEM_PER_BLOCK = 232_448
# K9 keeps heads resident where two such blocks fit an SM, in blocks of 8 warps
K9_RESIDENT_LIMIT = 113 * 1024
K9_RESIDENT_WARPS = 8
# query rows, keys, head dims and output columns of the kernels' tiles
TILE = 64


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _mha_rows_smem(s: int, d: int, itemsize: int) -> int:
    """K8's shared memory per block (``csrc/mha_rows.cu: smem_bytes``): the
    float32 q tile (rows of 64 + 4 floats, or 128 + 4 where the head dim is
    above 64), the mm(ex) tile (rows of 72), for bf16 input a float32 64 x 64
    K or V tile, and two raw slots of a 64 x 64 K or V tile (rows of 68
    floats or 72 bf16); 64 query rows where S <= 64 or the head dim is
    above 64, else 128. Bounded whatever S and the head dim: at most 107,520
    bytes."""
    slices = 2 if d > TILE else 1
    rows = 64 if s <= TILE or d > TILE else 128
    wide = itemsize != 4
    floats = rows * (slices * TILE + 4 + TILE + 8) + (TILE * (TILE + 4) if wide else 0)
    return 4 * floats + itemsize * 2 * TILE * (TILE + (8 if wide else 4))


# K9's streamed layout: int8 tiles of 64 x 80 bytes for q8, k8, vT and the
# four warps' ex8 rows (``csrc/mha_rows_int8.cu: STREAMED_SMEM``)
K9_STREAMED_SMEM = 4 * TILE * (TILE + 16)


def _mha_rows_int8_layout(s: int, d: int, itemsize: int):
    """K9's layout and shared memory per block (``csrc/mha_rows_int8.cu``):
    ``(True, bytes)`` for the resident layout (``Resident``: q8, k8, the
    transposed v8, eight warps' 16 x 64 ex8 tiles, the block reduction and
    two buffers of a head's raw q, k and v rows) where it fits in
    :data:`K9_RESIDENT_LIMIT`, else ``(False, K9_STREAMED_SMEM)``: the
    absmax pre-pass and 64 x 64 int8 tiles, whatever S and D."""
    sp, dp = _round_up(s, 32), _round_up(d, 32)
    ex = _round_up(2 * sp * (dp + 16) + d * (sp + 16), 16)
    red = _round_up(ex + K9_RESIDENT_WARPS * 16 * (TILE + 16), 16)
    raw = _round_up(red + K9_RESIDENT_WARPS * 3 * 4, 16)
    resident = raw + 2 * 3 * s * d * itemsize
    if resident <= K9_RESIDENT_LIMIT:
        return True, resident
    return False, K9_STREAMED_SMEM


def _mha_rows_int8_smem(s: int, d: int, itemsize: int) -> int:
    """K9's shared memory per block at (S, head dim, input item size)."""
    return _mha_rows_int8_layout(s, d, itemsize)[1]


def _require_launchable(what: str, b: int, d: int, heads: int) -> None:
    """Raise ValueError, before launch, for a shape the kernels do not take:
    a head dim that is not a multiple of 8, or more than 65,535 images or
    heads (a grid dimension). Every shape the dispatch admits passes."""
    if d % 8:
        raise ValueError(f"{what}: head dim {d} must be a multiple of 8")
    if b > 65535 or heads > 65535:
        raise ValueError(f"{what}: {b} images x {heads} heads: at most 65,535 of each")


def _mha_ref(qkv: torch.Tensor, num_heads: int, causal: bool, out_dtype,
             valid_len: int = 0) -> torch.Tensor:
    """(B, S, 3E) -> (B, S, E) with the kernel's arithmetic (see module)."""
    b, s, three_e = qkv.shape
    e = three_e // 3
    d = e // num_heads
    mm = torch.bfloat16 if qkv.dtype == torch.bfloat16 else torch.float32
    x = qkv.reshape(b, s, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # (3, B, H, S, d)
    scale = torch.tensor(1.0 / (d ** 0.5), dtype=torch.float32)
    q = (x[0].float() * scale).to(mm).float()
    k, v = x[1].to(mm).float(), x[2].to(mm).float()
    sc = q @ k.transpose(-1, -2)  # bf16 operands are exact in float32
    valid = int(valid_len) or s
    if causal or valid < s:
        rows = torch.arange(s, device=qkv.device).reshape(s, 1)
        cols = torch.arange(s, device=qkv.device).reshape(1, s)
        if causal:
            ok = cols <= rows
            if valid < s:
                ok = ok & (cols < valid) & (rows < valid)
        else:
            ok = cols < valid
        limit = torch.where(ok, torch.tensor(3e38, dtype=torch.float32),
                            torch.tensor(-1e30, dtype=torch.float32))
        sc = torch.minimum(sc, limit.to(qkv.device))
    m = torch.clamp_min(sc.amax(dim=-1, keepdim=True), -80.0)
    ex = torch.exp(sc - m)
    norm = torch.clamp_min(ex.sum(dim=-1, keepdim=True), 1e-37)
    out = (ex.to(mm).float() @ v) / norm  # (B, H, S, d)
    return out.permute(0, 2, 1, 3).reshape(b, s, e).to(out_dtype)


def mha_rows_plain(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool,
                   out_dtype: torch.dtype, valid_len: int) -> torch.Tensor:
    """Plain version of kernel K8 over (B*S, 3E) rows."""
    rows, three_e = qkv.shape
    s = int(seq_len)
    out = _mha_ref(qkv.reshape(rows // s, s, three_e), num_heads, causal, out_dtype, valid_len)
    return out.reshape(rows, three_e // 3)


@_cost.reports("mha_rows")
def mha_rows(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool,
             out_dtype: torch.dtype, valid_len: int) -> torch.Tensor:
    """Kernel K8: CPU tensors take :func:`mha_rows_plain`; CUDA tensors
    launch ``csrc/mha_rows.cu`` or raise."""
    if torch.compiler.is_exporting():
        return torch.ops.qtt.mha_rows(qkv, num_heads, seq_len, bool(causal), out_dtype,
                                      valid_len)
    dev = qkv.device
    if dev.type == "cpu":
        return mha_rows_plain(qkv, num_heads, seq_len, causal, out_dtype, valid_len)
    if dev.type != "cuda":
        raise ValueError(f"mha_rows: unsupported device {dev}")
    b, s, e, d = _split(qkv, num_heads, seq_len, "mha_rows")
    _require_launchable("mha_rows", b, d, num_heads)
    valid = int(valid_len) or s
    in_code, out_code = _build.dtype_code(qkv.dtype), _build.dtype_code(out_dtype)
    _build.require(qkv, "qkv", dev, qkv.dtype, (b * s, 3 * e))
    out = torch.empty((b * s, e), dtype=out_dtype, device=dev)
    fn = _build.kernel_fn("mha_rows")
    with _build.device_guard(dev):
        err = fn(_build.ptr(qkv), _build.ptr(out), b, s, num_heads, d, valid, int(bool(causal)),
                 1.0 / (d ** 0.5), in_code, out_code, _build.current_stream(dev))
    _build.check(err, "mha_rows")
    mha_rows.launches += 1
    return out


mha_rows.launches = 0


# ---------------------------------------------------------------------------
# K9: int8 scores
# ---------------------------------------------------------------------------

def _quant_sym(t: torch.Tensor):
    """Dynamic symmetric int8 of (B, H, S, d) per (image, head): the absmax
    over all S x d values, ``sc = max(absmax, 1e-12) / 127`` and
    ``q = clip(round(t / sc), -127, 127)`` (true divisions, round half to
    even). Returns q as float (integers) and sc (B, H, 1, 1)."""
    a = t.float()
    f32 = dict(dtype=torch.float32, device=a.device)
    absmax = a.abs().amax(dim=(-2, -1), keepdim=True)
    sc = torch.maximum(absmax, torch.tensor(1e-12, **f32)) / torch.tensor(127.0, **f32)
    return torch.clamp(torch.round(a / sc), -127, 127), sc


def mha_rows_int8_plain(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool,
                        out_dtype: torch.dtype, valid_len: int) -> torch.Tensor:
    """Plain version of kernel K9 over (B*S, 3E) rows: the Pallas
    ``_mha_rows_int8_kernel`` body (``attention.py:163-201``) step by step.
    Integer products are summed in float64, where they are exact."""
    rows, three_e = qkv.shape
    s = int(seq_len)
    b, e = rows // s, three_e // 3
    d = e // num_heads
    f32 = dict(dtype=torch.float32, device=qkv.device)
    x = qkv.reshape(b, s, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # (3, B, H, S, d)
    (q8, sq), (k8, sk), (v8, sv) = (_quant_sym(x[i]) for i in range(3))
    acc = (q8.double() @ k8.double().transpose(-1, -2)).float()  # (B, H, S, S) integers
    scores = acc * ((sq * sk) * torch.tensor(1.0 / (d ** 0.5), **f32))
    valid = int(valid_len) or s
    if causal or valid < s:
        r = torch.arange(s, device=qkv.device).reshape(s, 1)
        c = torch.arange(s, device=qkv.device).reshape(1, s)
        ok = c < valid
        if causal:
            ok = ok & (c <= r)
        scores = torch.where(ok, scores, torch.tensor(-1e30, **f32))
    m = scores.amax(dim=-1, keepdim=True)
    ex8 = torch.round(torch.exp(scores - m) * torch.tensor(127.0, **f32))  # [0, 127]
    norm = ex8.sum(dim=-1, keepdim=True)  # integers: exact in float32
    av = (ex8.double() @ v8.double()).float()
    out = av * (sv / torch.clamp_min(norm, 1.0))
    return out.permute(0, 2, 1, 3).reshape(rows, e).to(out_dtype)


@_cost.reports("mha_rows_int8")
def mha_rows_int8(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool,
                  out_dtype: torch.dtype, valid_len: int) -> torch.Tensor:
    """Kernel K9: CPU tensors take :func:`mha_rows_int8_plain`; CUDA
    tensors launch ``csrc/mha_rows_int8.cu`` or raise."""
    if torch.compiler.is_exporting():
        return torch.ops.qtt.mha_rows_int8(qkv, num_heads, seq_len, bool(causal), out_dtype,
                                           valid_len)
    dev = qkv.device
    if dev.type == "cpu":
        return mha_rows_int8_plain(qkv, num_heads, seq_len, causal, out_dtype, valid_len)
    if dev.type != "cuda":
        raise ValueError(f"mha_rows_int8: unsupported device {dev}")
    b, s, e, d = _split(qkv, num_heads, seq_len, "mha_rows_int8")
    _require_launchable("mha_rows_int8", b, d, num_heads)
    resident, _ = _mha_rows_int8_layout(s, d, qkv.element_size())
    in_code, out_code = _build.dtype_code(qkv.dtype), _build.dtype_code(out_dtype)
    _build.require(qkv, "qkv", dev, qkv.dtype, (b * s, 3 * e))
    out = torch.empty((b * s, e), dtype=out_dtype, device=dev)
    # the streamed layout's (B, H, 3) absmax scales, written by its pre-pass
    scales = None if resident else torch.empty((b, num_heads, 3), dtype=torch.float32, device=dev)
    fn = _build.kernel_fn("mha_rows_int8")
    with _build.device_guard(dev):
        err = fn(_build.ptr(qkv), _build.ptr(out), _build.ptr(scales), b, s, num_heads, d,
                 int(valid_len) or s, int(bool(causal)), 1.0 / (d ** 0.5), in_code, out_code,
                 int(resident), _build.current_stream(dev))
    _build.check(err, "mha_rows_int8")
    mha_rows_int8.launches += 1
    if not resident:
        mha_rows_int8.absmax_launches += 1
    return out


mha_rows_int8.launches = 0
# launches of the streamed layout's absmax pre-pass (a second kernel of the call)
mha_rows_int8.absmax_launches = 0


# ---------------------------------------------------------------------------
# The JAX oracle and the dispatch
# ---------------------------------------------------------------------------

def mha_oracle_rows(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool,
                    out_dtype: torch.dtype, valid_len: int = 0) -> torch.Tensor:
    """JAX's ``_mha_ref_rows``, the attention the JAX package runs for the
    shapes its kernels do not take: float32 einsums, a true division by
    sqrt(d), pad keys set to -1e30, the causal mask added as -1e30 above the
    diagonal, then ``exp(x - max) / sum``. Torch ops, on any device."""
    rows, three_e = qkv.shape
    s = int(seq_len)
    b, e = rows // s, three_e // 3
    d = e // num_heads
    f32 = dict(dtype=torch.float32, device=qkv.device)
    x = qkv.reshape(b, s, 3, num_heads, d).permute(2, 0, 3, 1, 4).float()  # (3, B, H, S, d)
    scores = (x[0] @ x[1].transpose(-1, -2)) / torch.tensor(d ** 0.5, **f32)
    valid = int(valid_len) or s
    if valid < s:
        keymask = (torch.arange(s, device=qkv.device) < valid).reshape(1, 1, 1, s)
        scores = torch.where(keymask, scores, torch.tensor(-1e30, **f32))
    if causal:
        scores = scores + torch.triu(torch.full((s, s), -1e30, **f32), diagonal=1)
    ex = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    attn = ex / ex.sum(dim=-1, keepdim=True)
    out = attn @ x[2]
    return out.permute(0, 2, 1, 3).reshape(rows, e).to(out_dtype)


def _split(qkv: torch.Tensor, num_heads: int, seq_len: int, what: str):
    """(B, S, E, d) of (B*S, 3E) rows; raises if they do not split."""
    rows, three_e = qkv.shape
    e = three_e // 3
    d = e // num_heads
    s = int(seq_len)
    b = rows // s
    if 3 * e != three_e or d * num_heads != e or b * s != rows:
        raise ValueError(f"{what}: qkv {tuple(qkv.shape)} does not split into "
                         f"{num_heads} heads x {s} rows")
    return b, s, e, d


def int8_scores_default() -> bool:
    """JAX's ``_int8_scores_default``: ``QTPU_ATTN_INT8=1`` selects K9."""
    return os.environ.get("QTPU_ATTN_INT8", "0") == "1"


def _softmax_group_size(s: int) -> int:
    """JAX's heads per batched-softmax group (``attention.py:43-48``)."""
    return max(1, int(6 * 1024 * 1024 // (2 * 4 * s * s)))


def kernel_takes(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool,
                 valid_len: int) -> bool:
    """The JAX package's shape dispatch (``attention.py:246-261``): its
    Pallas kernels take d % 8 == 0, S % 8 == 0 and a VMEM estimate of at
    most 12 MB; every other shape runs the oracle."""
    b, s, e, d = _split(qkv, num_heads, seq_len, "mha_fused_qkv_rows")
    valid = int(valid_len) or s
    itemsize = qkv.element_size()
    g_eff = min(num_heads, _softmax_group_size(s))
    mask_bytes = g_eff * s * s * 4 if causal else (s * 4 if valid < s else 0)
    vmem_est = (s * 3 * e * itemsize + 3 * s * d * 4 + 2 * g_eff * s * s * 4 + mask_bytes
                + s * e * (4 + itemsize))
    return d % 8 == 0 and s % 8 == 0 and vmem_est <= 12 * 1024 * 1024


def mha_fused_qkv_rows(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool = False,
                       out_dtype=None, valid_len: int = 0, int8_scores=None) -> torch.Tensor:
    """Multi-head self-attention over fused qkv rows.

    Args:
        qkv: (B*S, 3E), the fused q/k/v projection output, batch-major rows.
        num_heads: H; head_dim = E // H.
        seq_len: S (padded); B = rows // S.
        causal: apply a causal mask.
        valid_len: number of real rows per image (0 = all of S); pad keys
            are masked out, pad query rows come out finite.
        int8_scores: K9 instead of K8 (None: :func:`int8_scores_default`).
    Returns:
        (B*S, E) attention output (before the out-projection), same rows.
    """
    out_dtype = out_dtype or qkv.dtype
    if int8_scores is None:
        int8_scores = int8_scores_default()
    if not kernel_takes(qkv, num_heads, seq_len, causal, valid_len):
        return mha_oracle_rows(qkv, num_heads, seq_len, causal, out_dtype, valid_len)
    kernel = mha_rows_int8 if int8_scores else mha_rows
    return kernel(qkv.contiguous(), num_heads, seq_len, causal, out_dtype, valid_len)


def mha_fused_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False,
                  out_dtype=None, int8_scores=None) -> torch.Tensor:
    """3-D convenience wrapper: (B, S, 3E) -> (B, S, E) through the rows
    dispatch, padding S up to a multiple of 8 (pad keys masked)."""
    b, s, three_e = qkv.shape
    e = three_e // 3
    s_pad = -(-s // 8) * 8
    if s_pad != s:
        qkv = torch.nn.functional.pad(qkv, (0, 0, 0, s_pad - s))
    out = mha_fused_qkv_rows(qkv.reshape(b * s_pad, three_e), num_heads, s_pad, causal=causal,
                             out_dtype=out_dtype, valid_len=s, int8_scores=int8_scores)
    out = out.reshape(b, s_pad, e)
    return out[:, :s] if s_pad != s else out
