"""Quantized multi-head self-attention.

PyTorch counterpart of ``quantize_tpu/nn/attention.py`` (the reference's
``QuantMultiheadAttention``): quantized q/k/v projections, and an
out-projection whose weight range is forced to MSE and whose input is not
quantized. Built from :class:`~quantize_tpu_torch.nn.layers.QuantDense`
children, so the calibrate / quant / pack / packed modes come from the
dense layer. In packed mode the q/k/v projections run as one fused matmul
(its int8 input straight from the deferred LayerNorm, kernel K7), or, for
weight-only layers, one by one after the LayerNorm (K6, then K5 each); the
attention middle is
:func:`~quantize_tpu_torch.ops.attention.mha_fused_qkv_rows` (kernel K8, or
K9 with ``QTPU_ATTN_INT8=1``); the other modes run the float einsum path on
the (de)quantized projections.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops.attention import mha_fused_qkv, mha_fused_qkv_rows
from ..ops.layernorm import layernorm, layernorm_quant_int8
from ..ops.qmatmul import _w4a8_route, _w8a8_route, quant_matmul_w4a8, quant_matmul_w8a8
from ..utils.config import dict_merge
from .layers import FP32, LayerQuantCfg, QuantDense
from .precision import packed_carry_dtype


def _proj_cfg(quant: LayerQuantCfg, force_mse: bool = False,
              disable_act: bool = False) -> LayerQuantCfg:
    weight = dict(quant.weight)
    activation = dict(quant.activation)
    if force_mse:
        # the reference forces the out-projection weight estimator to MSE
        rng_cfg = dict(weight.get("range") or {})
        if rng_cfg.get("name") != "awq":
            weight["range"] = dict_merge(rng_cfg, {"name": "mse"})
        else:
            weight["range"] = {"name": "mse"}
    if disable_act:
        activation = {"n_bits": 32}
    return LayerQuantCfg(weight=weight, activation=activation, bias_correct=quant.bias_correct)


def _fused_qkv_packed(x: torch.Tensor, mods: Sequence[QuantDense], pre_norm=None
                      ) -> Optional[torch.Tensor]:
    """Run the q/k/v projections as ONE fused int8 matmul in packed mode.

    They share the quant config and the input, so their activation qparams
    are identical and the per-out-channel weight buffers concatenate
    exactly. With ``pre_norm`` (the deferred LayerNorm's ``(scale, bias,
    eps)``) the normalize fuses into the activation quantize. Returns None
    when the layout is not fusable (weight-only, per-channel activations,
    an odd K for int4); the caller then runs the projections one by one.
    """
    w_spec, a_spec = mods[0].w_spec, mods[0].a_spec
    if not (w_spec.enabled and a_spec.enabled and not a_spec.per_channel):
        return None
    if w_spec.range_name == "awq":
        return None
    bufs = [m.packed_proj_buffers() for m in mods]
    p4 = "w_p4" in bufs[0]
    w_key = "w_p4" if p4 else "w_int"
    if any(w_key not in b or "a_scale" not in b for b in bufs):
        return None

    def cat(key):
        return torch.cat([b[key].reshape(-1) for b in bufs])

    a_scale = bufs[0]["a_scale"].reshape(())
    a_zero = bufs[0]["a_zero"].reshape(())
    wz0 = bool(w_spec.symmetric and w_spec.qmin < 0)
    pre_q = None
    if pre_norm is not None:
        pre_q = layernorm_quant_int8(x, *pre_norm, a_scale, a_zero, a_spec.qmin, a_spec.qmax)
    if p4:
        w, w_km = fused_w4_operands(bufs, x.device, x.shape[-1])
        qkv = quant_matmul_w4a8(x, a_scale, a_zero, a_spec.qmin, a_spec.qmax, w, cat("w_scale"),
                                cat("w_zero"), cat("bias"), cat("col_sum"), w_zero_is_zero=wz0,
                                pre_q=pre_q, w_km=w_km)
    else:
        w, w_km = fused_w8_operands(bufs, x.device, x.shape[-1])
        qkv = quant_matmul_w8a8(x, a_scale, a_zero, a_spec.qmin, a_spec.qmax, w, cat("w_scale"),
                                cat("w_zero"), cat("bias"), cat("col_sum"), w_zero_is_zero=wz0,
                                pre_q=pre_q, w_km=w_km)
    return qkv.to(packed_carry_dtype())


def fused_w8_operands(bufs: Sequence[dict], device: torch.device, k: int):
    """``(w_int, w_km)`` of the fused q/k/v int8 weight, of which only what K1
    reads on ``device`` is made, as :func:`fused_w4_operands` does for K4."""
    if device.type == "cuda" and _w8a8_route(k) == "wgmma":
        return None, torch.cat([b["w_kmajor"] for b in bufs], dim=0)
    return torch.cat([b["w_int"] for b in bufs], dim=1), None


def fused_w4_operands(bufs: Sequence[dict], device: torch.device, k: int):
    """``(w_p4, w_km)`` of the fused q/k/v int4 weight, of which only what K4
    reads on ``device`` is made: the K-major copies concatenated along dim 0
    (the other None) where the kernel takes the wgmma route, else the packed
    weights along dim 1 (the mma.sync route and the plain version read
    them)."""
    if device.type == "cuda" and _w4a8_route(k) == "wgmma":
        return None, torch.cat([b["w_p4_kmajor"] for b in bufs], dim=0)
    return torch.cat([b["w_p4"] for b in bufs], dim=1), None


class QuantMultiheadAttention(nn.Module):
    """Self-attention with quantized projections over (batch, seq, embed)
    inputs, or 2-D (batch*seq, embed) rows with ``seq_len`` given."""

    def __init__(self, embed_dim: int, num_heads: int, quant: LayerQuantCfg = FP32,
                 use_bias: bool = True, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        pc = _proj_cfg(quant)
        self.q_proj = QuantDense(embed_dim, embed_dim, use_bias, pc, device)
        self.k_proj = QuantDense(embed_dim, embed_dim, use_bias, pc, device)
        self.v_proj = QuantDense(embed_dim, embed_dim, use_bias, pc, device)
        oc = _proj_cfg(quant, force_mse=True, disable_act=True)
        self.out_proj = QuantDense(embed_dim, embed_dim, use_bias, oc, device)

    def forward(self, x: torch.Tensor, mode: str = "fp32",
                mask: Union[None, str, torch.Tensor] = None, pre_norm=None,
                seq_len: Optional[int] = None, valid_len: int = 0) -> torch.Tensor:
        """``mask``: None, an additive array, or the string ``"causal"``.
        ``pre_norm`` (packed mode): a deferred LayerNorm's ``params_tuple()``.
        ``valid_len`` (2-D rows): real rows per sequence; pad keys are masked."""
        head_dim = self.embed_dim // self.num_heads
        rows_2d = x.dim() == 2
        if rows_2d:
            if not seq_len:
                raise ValueError("2-D attention input needs seq_len")
            s = int(seq_len)
            b = x.shape[0] // s
        else:
            b, s, _ = x.shape
        causal = isinstance(mask, str) and mask == "causal"
        projs = (self.q_proj, self.k_proj, self.v_proj)
        fused = _fused_qkv_packed(x, projs, pre_norm) if mode == "packed" else None

        if fused is None and pre_norm is not None:
            x = layernorm(x, *pre_norm, out_dtype=x.dtype)
        if mode == "packed" and (mask is None or causal):
            # the fused attention middle: scores and softmax stay on chip
            qkv = fused if fused is not None else torch.cat([p(x, mode=mode) for p in projs], -1)
            if rows_2d:
                out = mha_fused_qkv_rows(qkv, self.num_heads, s, causal=causal,
                                         out_dtype=qkv.dtype, valid_len=valid_len)
            else:
                out = mha_fused_qkv(qkv, self.num_heads, causal=causal, out_dtype=qkv.dtype)
        else:
            if fused is not None:
                n = self.embed_dim
                q, k, v = fused[..., :n], fused[..., n:2 * n], fused[..., 2 * n:]
            else:
                q, k, v = (p(x, mode=mode) for p in projs)

            def split(t):
                return t.reshape(b, s, self.num_heads, head_dim).transpose(1, 2)

            qh, kh, vh = split(q), split(k), split(v)
            scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / torch.sqrt(
                torch.tensor(float(head_dim), device=x.device)).to(x.dtype)
            if causal:
                mask = torch.triu(torch.full((s, s), float("-inf"), dtype=scores.dtype,
                                             device=x.device), diagonal=1)
            elif mask is not None and rows_2d and mask.shape[-1] != s:
                # padded-rows callers must build the mask for the padded length
                raise ValueError(f"attention mask last dim {mask.shape[-1]} != padded "
                                 f"seq_len {s}; build masks for the padded length")
            if mask is not None:
                scores = scores + mask
            if rows_2d and 0 < valid_len < s:
                # pad keys are never attended, as in the fused kernel
                keymask = (torch.arange(s, device=x.device) < valid_len).reshape(1, 1, 1, s)
                scores = torch.where(keymask, scores,
                                     torch.tensor(-1e30, dtype=scores.dtype, device=x.device))
            attn = torch.softmax(scores, dim=-1)
            out = torch.einsum("bhqk,bhkd->bhqd", attn, vh).transpose(1, 2)
            out = (out.reshape(b * s, self.embed_dim) if rows_2d
                   else out.reshape(b, s, self.embed_dim))
        return self.out_proj(out, mode=mode)
