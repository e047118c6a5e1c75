"""Reference (plain PyTorch) implementations of the packed quantized ops.

PyTorch counterpart of ``quantize_tpu/ops/ref.py``: simple, obviously
correct oracles (dequantize, then a float op) for the kernels' tests.

Quantization algebra (``x̂ = (q + zero)·scale``) makes a quantized matmul

    out[m,n] = s_a·s_w[n] · ( Σ_k q_a·q_w + z_a·Σ_k q_w[k,n]
                              + z_w[n]·Σ_k q_a[m,k] + K·z_a·z_w[n] ) + bias
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .qconv import conv_nhwc


def quantize_activation_int8(x: torch.Tensor, scale, zero, qmin: int, qmax: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize activations for the int8 path; unsigned grids ([0, 255]) are
    shifted by -128 with the shift folded into the returned zero point."""
    zero = torch.as_tensor(zero, dtype=torch.float32)
    q = torch.clamp(torch.round(x / scale - zero), qmin, qmax)
    if qmin >= 0:
        q = q - 128.0
        zero = zero + 128.0
    return q.to(torch.int8), zero


def quant_matmul_ref(x, a_scale, a_zero, a_qmin, a_qmax, w_int, w_scale, w_zero,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize-on-the-fly matmul, oracle form: dequantize then matmul."""
    q_a, z_a = quantize_activation_int8(x, a_scale, a_zero, a_qmin, a_qmax)
    a_deq = (q_a.float() + z_a) * a_scale
    w_deq = (w_int.float() + w_zero[None, :]) * w_scale[None, :]
    out = a_deq @ w_deq
    return out if bias is None else out + bias


def quant_matmul_int_ref(x, a_scale, a_zero, a_qmin, a_qmax, w_int, w_scale, w_zero,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same result as :func:`quant_matmul_ref` via exact integer accumulation
    plus the zero-point corrections (the algebra the kernels implement)."""
    q_a, z_a = quantize_activation_int8(x, a_scale, a_zero, a_qmin, a_qmax)
    k = x.shape[-1]
    acc = (q_a.long() @ w_int.long()).float()
    col_sum_w = w_int.long().sum(0).float()
    row_sum_a = q_a.long().sum(-1, keepdim=True).float()
    corrected = (acc + z_a * col_sum_w[None, :] + w_zero[None, :] * row_sum_a
                 + k * z_a * w_zero[None, :])
    out = a_scale * w_scale[None, :] * corrected
    return out if bias is None else out + bias


def quant_matmul_wo_ref(x: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor,
                        w_zero: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weight-only-quantized matmul (float activations): the weight
    dequantized ``(w + z)·s`` in float32, then ``x @ w_deq``."""
    w_deq = (w_int.float() + w_zero[None, :]) * w_scale[None, :]
    out = x @ w_deq
    return out if bias is None else out + bias


def im2col(x: torch.Tensor, kh: int, kw: int, strides: Sequence[int] = (1, 1),
           padding: Union[str, Sequence[Tuple[int, int]]] = "SAME"
           ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """NHWC -> (N, H', W', kh*kw*C) patches for conv-as-matmul, features in
    the HWIO kernel's flattening order (kh, kw, C); ``"SAME"`` pads as JAX's
    ``im2col`` does (the extra row or column at the end)."""
    n, h, w, c = x.shape
    if padding == "SAME":
        pad_h = max((-(-h // strides[0]) - 1) * strides[0] + kh - h, 0)
        pad_w = max((-(-w // strides[1]) - 1) * strides[1] + kw - w, 0)
        pads = [(pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2)]
    elif padding == "VALID":
        pads = [(0, 0), (0, 0)]
    else:
        pads = [tuple(p) for p in padding]
    xp = F.pad(x, (0, 0, pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    h_out = (xp.shape[1] - kh) // strides[0] + 1
    w_out = (xp.shape[2] - kw) // strides[1] + 1
    # (N, H', W', C, kh, kw) windows, then (kh, kw, C) order
    win = xp.unfold(1, kh, strides[0]).unfold(2, kw, strides[1])
    patches = win.permute(0, 1, 2, 4, 5, 3).reshape(n, h_out, w_out, kh * kw * c)
    return patches, (h_out, w_out)


def quant_conv2d_ref(x, a_scale, a_zero, a_qmin, a_qmax, w_int, w_scale, w_zero,
                     bias=None, strides: Sequence[int] = (1, 1),
                     padding: Union[str, Sequence[Tuple[int, int]]] = "SAME") -> torch.Tensor:
    """Oracle packed conv: dequantize weight + fake-quant input, float conv."""
    q_a, z_a = quantize_activation_int8(x, a_scale, a_zero, a_qmin, a_qmax)
    a_deq = (q_a.float() + z_a) * a_scale
    w_deq = (w_int.float() + w_zero) * w_scale
    out = conv_nhwc(a_deq, w_deq, strides, padding)
    return out if bias is None else out + bias
