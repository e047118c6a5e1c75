"""Fused multi-head attention for packed transformer inference: kernel K8.

PyTorch counterpart of ``quantize_tpu/ops/pallas/attention.py``. The packed
attention middle reads the fused q/k/v projection output as 2-D
``(B*S, 3E)`` rows (q of head h at lanes ``[h*d, (h+1)*d)``, k at
``E + h*d``, v at ``2E + h*d``) and writes ``(B*S, E)`` rows: no reshape to
4-D and no (S, S) score tensor in device memory. :func:`mha_rows` launches
the hand-written kernel ``csrc/mha_rows.cu`` on CUDA tensors and runs
:func:`mha_rows_plain` on CPU tensors.

Both follow the Pallas ``_mha_rows_kernel`` exactly: q scaled in float32
and rounded to the product dtype (bf16 for a bf16 input), f32-summed
scores, masking by ``min(sc, -1e30)``, the row max floored at -80, the
normalizer floored at 1e-37, the exp weights rounded to the product dtype
before the AV product while the normalizer sums them in float32, and
``1/sum`` applied to the (S, D) output.
"""
from __future__ import annotations

import torch

from . import _build


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
    rows, three_e = qkv.shape
    e = three_e // 3
    d = e // num_heads
    s = int(seq_len)
    b = rows // s
    if 3 * e != three_e or d * num_heads != e or b * s != rows:
        raise ValueError(f"mha_rows: qkv {tuple(qkv.shape)} does not split into "
                         f"{num_heads} heads x {s} rows")
    if d % 4:
        raise ValueError(f"mha_rows: head dim {d} must be a multiple of 4")
    valid = int(valid_len) or s
    in_code, out_code = _build.dtype_code(qkv.dtype), _build.dtype_code(out_dtype)
    _build.require(qkv, "qkv", dev, qkv.dtype, (rows, three_e))
    out = torch.empty((rows, e), dtype=out_dtype, device=dev)
    fn = _build.kernel_fn("mha_rows")
    with torch.cuda.device(dev):
        err = fn(_build.ptr(qkv), _build.ptr(out), b, s, num_heads, d, valid, int(bool(causal)),
                 1.0 / (d ** 0.5), in_code, out_code, _build.current_stream(dev))
    _build.check(err, "mha_rows")
    mha_rows.launches += 1
    return out


mha_rows.launches = 0


def mha_fused_qkv_rows(qkv: torch.Tensor, num_heads: int, seq_len: int, causal: bool = False,
                       out_dtype=None, valid_len: int = 0) -> torch.Tensor:
    """Multi-head self-attention over fused qkv rows.

    Args:
        qkv: (B*S, 3E), the fused q/k/v projection output, batch-major rows.
        num_heads: H; head_dim = E // H.
        seq_len: S (padded); B = rows // S.
        causal: apply a causal mask.
        valid_len: number of real rows per image (0 = all of S); pad keys
            are masked out, pad query rows come out finite.
    Returns:
        (B*S, E) attention output (before the out-projection), same rows.
    """
    out_dtype = out_dtype or qkv.dtype
    return mha_rows(qkv.contiguous(), num_heads, seq_len, causal, out_dtype, valid_len)


def mha_fused_qkv(qkv: torch.Tensor, num_heads: int, causal: bool = False,
                  out_dtype=None) -> torch.Tensor:
    """3-D convenience wrapper: (B, S, 3E) -> (B, S, E) through the rows
    kernel, padding S up to a multiple of 8 (pad keys masked)."""
    b, s, three_e = qkv.shape
    e = three_e // 3
    s_pad = -(-s // 8) * 8
    if s_pad != s:
        qkv = torch.nn.functional.pad(qkv, (0, 0, 0, s_pad - s))
    out = mha_fused_qkv_rows(qkv.reshape(b * s_pad, three_e), num_heads, s_pad, causal=causal,
                             out_dtype=out_dtype, valid_len=s)
    out = out.reshape(b, s_pad, e)
    return out[:, :s] if s_pad != s else out
