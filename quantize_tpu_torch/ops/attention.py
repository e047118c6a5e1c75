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

Both kernels take every shape the dispatch sends them at head dims up to
256 (a multiple of 8, as the dispatch requires), in float32 and bf16,
causal or not: their shared memory stays within a block's at every S the
dispatch admits (:func:`_mha_rows_smem`, :func:`_mha_rows_int8_smem`;
where all rows do not fit, K8 narrows its tiles and K9 takes q in 64-row
groups and quantizes k and v chunk by chunk). A head dim above 256 raises
ValueError naming it, as does a shape whose tiles would not fit, before
launch; no model of the repository or of the public ViT and CLIP families
has such a head dim.

* K8, :func:`mha_rows` (``csrc/mha_rows.cu``; :func:`mha_rows_plain` on CPU
  tensors), follows the Pallas ``_mha_rows_kernel`` exactly: q scaled in
  float32 and rounded to the product dtype (bf16 for a bf16 input),
  f32-summed scores, masking by ``min(sc, -1e30)``, the row max floored at
  -80, the normalizer floored at 1e-37, the exp weights rounded to the
  product dtype before the AV product while the normalizer sums them in
  float32, and ``1/sum`` applied to the (S, D) output.
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

from . import _build

# the shared memory one block may use on the H100 (227 KB)
SMEM_PER_BLOCK = 232_448


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _mha_rows_smem(s: int, d: int) -> int:
    """K8's shared memory per block (``csrc/mha_rows.cu: Tiling``): a chunk
    of K or V and the query rows, D + 4 floats a row, and the query rows'
    score tile with S padded to the chunk. The wide tiling (32 rows,
    224-key chunks) where it fits, else the narrow one (16 rows, 64 keys)."""
    def tiling(qt: int, kchunk: int) -> int:
        return 4 * ((kchunk + qt) * (d + 4) + qt * _round_up(s, kchunk) + qt)

    wide = tiling(32, 224)
    return wide if wide <= SMEM_PER_BLOCK else tiling(16, 64)


def _mha_rows_int8_layout(s: int, d: int, qg: int, kc: int) -> int:
    """K9's shared memory for ``qg`` query rows and ``kc`` keys held at a
    time (``csrc/mha_rows_int8.cu: Layout``): q8 and k8, the transposed v8,
    four warps' ex8 tiles of 16 rows x min(kc, 256) keys and, when the keys
    come in more than one chunk, the int32 partial AV sums."""
    sp, dp = _round_up(s, 32), _round_up(d, 32)
    ex = _round_up((qg + kc) * (dp + 16) + d * (kc + 16), 16)
    acc = _round_up(ex + 4 * 16 * (min(kc, 256) + 16), 16)
    red = _round_up(acc + (qg * d * 4 if kc < sp else 0), 16)
    return red + 4 * 3 * 4


def _mha_rows_int8_smem(s: int, d: int) -> int:
    """K9's shared memory per block: all rows resident where they fit, else
    64-row query groups over key chunks of 256, 128, 64 or 32, the largest
    that fits (``Layout::choose``)."""
    sp = _round_up(s, 32)
    choices = [(sp, sp)] + [(64, kc) for kc in (256, 128, 64, 32) if kc < sp]
    for qg, kc in choices:
        nbytes = _mha_rows_int8_layout(s, d, qg, kc)
        if nbytes <= SMEM_PER_BLOCK:
            break
    return nbytes


# the largest head dim the kernels take
MAX_HEAD_DIM = 256


def _require_smem(what: str, nbytes: int, s: int, d: int) -> None:
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} is above {MAX_HEAD_DIM}, the largest the "
                         f"kernel takes")
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(f"{what}: S = {s} at head dim {d} needs {nbytes} bytes of shared "
                         f"memory per block, above the limit of {SMEM_PER_BLOCK}")


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


def mha_rows(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool,
             out_dtype: torch.dtype, valid_len: int) -> torch.Tensor:
    """Kernel K8: CPU tensors take :func:`mha_rows_plain`; CUDA tensors
    launch ``csrc/mha_rows.cu`` or raise."""
    dev = qkv.device
    if dev.type == "cpu":
        return mha_rows_plain(qkv, num_heads, seq_len, causal, out_dtype, valid_len)
    if dev.type != "cuda":
        raise ValueError(f"mha_rows: unsupported device {dev}")
    b, s, e, d = _split(qkv, num_heads, seq_len, "mha_rows")
    if d % 4:
        raise ValueError(f"mha_rows: head dim {d} must be a multiple of 4")
    _require_smem("mha_rows", _mha_rows_smem(s, d), s, d)
    valid = int(valid_len) or s
    in_code, out_code = _build.dtype_code(qkv.dtype), _build.dtype_code(out_dtype)
    _build.require(qkv, "qkv", dev, qkv.dtype, (b * s, 3 * e))
    out = torch.empty((b * s, e), dtype=out_dtype, device=dev)
    fn = _build.kernel_fn("mha_rows")
    with torch.cuda.device(dev):
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


def mha_rows_int8(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool,
                  out_dtype: torch.dtype, valid_len: int) -> torch.Tensor:
    """Kernel K9: CPU tensors take :func:`mha_rows_int8_plain`; CUDA
    tensors launch ``csrc/mha_rows_int8.cu`` or raise."""
    dev = qkv.device
    if dev.type == "cpu":
        return mha_rows_int8_plain(qkv, num_heads, seq_len, causal, out_dtype, valid_len)
    if dev.type != "cuda":
        raise ValueError(f"mha_rows_int8: unsupported device {dev}")
    b, s, e, d = _split(qkv, num_heads, seq_len, "mha_rows_int8")
    if d % 8:
        raise ValueError(f"mha_rows_int8: head dim {d} must be a multiple of 8")
    _require_smem("mha_rows_int8", _mha_rows_int8_smem(s, d), s, d)
    in_code, out_code = _build.dtype_code(qkv.dtype), _build.dtype_code(out_dtype)
    _build.require(qkv, "qkv", dev, qkv.dtype, (b * s, 3 * e))
    out = torch.empty((b * s, e), dtype=out_dtype, device=dev)
    fn = _build.kernel_fn("mha_rows_int8")
    with torch.cuda.device(dev):
        err = fn(_build.ptr(qkv), _build.ptr(out), b, s, num_heads, d, int(valid_len) or s,
                 int(bool(causal)), 1.0 / (d ** 0.5), in_code, out_code,
                 _build.current_stream(dev))
    _build.check(err, "mha_rows_int8")
    mha_rows_int8.launches += 1
    return out


mha_rows_int8.launches = 0


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
