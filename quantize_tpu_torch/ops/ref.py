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


def quant_conv2d_ref(x, a_scale, a_zero, a_qmin, a_qmax, w_int, w_scale, w_zero,
                     bias=None, strides: Sequence[int] = (1, 1),
                     padding: Union[str, Sequence[Tuple[int, int]]] = "SAME") -> torch.Tensor:
    """Oracle packed conv: dequantize weight + fake-quant input, float conv."""
    q_a, z_a = quantize_activation_int8(x, a_scale, a_zero, a_qmin, a_qmax)
    a_deq = (q_a.float() + z_a) * a_scale
    w_deq = (w_int.float() + w_zero) * w_scale
    out = conv_nhwc(a_deq, w_deq, strides, padding)
    return out if bias is None else out + bias
