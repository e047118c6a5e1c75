"""Fused 1x1-conv + residual-add + ReLU for packed CNN blocks: kernel K2.

PyTorch counterpart of ``quantize_tpu/ops/pallas/qconv1x1.py``. A stride-1
1x1 conv is a matmul over M = N·H·W rows, so the whole bottleneck tail is
one kernel:

    out = relu( s_a·s_w_c·(A_q·W_q + z_a·colsum_c(W_q)) + bias_c + residual )

reading the int8 activation and the residual once and writing the
carry-dtype output once. Weight zero points must be exactly zero.
:func:`conv1x1_residual_gemm` launches ``csrc/conv1x1_residual.cu`` on CUDA
tensors and runs :func:`conv1x1_residual_plain` on CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .qmatmul import int8_matmul_exact


def conv1x1_residual_plain(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                           w_int: torch.Tensor, col_sum: torch.Tensor,
                           w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                           res: torch.Tensor, relu: bool, out_dtype: torch.dtype
                           ) -> torch.Tensor:
    """Plain version of kernel K2 over 2-D (M, K) / (M, N) operands; the
    residual is added in f32 before the one cast to ``out_dtype``."""
    acc = int8_matmul_exact(q_a, w_int).float()
    out = a_scale * w_scale.reshape(1, -1) * (acc + z_eff * col_sum.float()[None, :])
    if bias is not None:
        out = out + bias
    out = out + res.float()
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(out_dtype)


def conv1x1_residual_gemm(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                          w_int: torch.Tensor, col_sum: torch.Tensor,
                          w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                          res: torch.Tensor, relu: bool, out_dtype: torch.dtype
                          ) -> torch.Tensor:
    """Kernel K2 on 2-D operands: q_a int8 (M, K), w_int int8 (K, N), col_sum
    int32 (N,), res f32/bf16 (M, N); returns (M, N) in ``out_dtype``."""
    dev = q_a.device
    if dev.type == "cpu":
        return conv1x1_residual_plain(q_a, z_eff, a_scale, w_int, col_sum, w_scale, bias,
                                      res, relu, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"conv1x1_residual: unsupported device {dev}")
    m, k = q_a.shape
    n = w_int.shape[1]
    _build.require(q_a, "q_a", dev, torch.int8, (m, k))
    _build.require(w_int, "w_int", dev, torch.int8, (k, n))
    _build.require(col_sum, "col_sum", dev, torch.int32, (n,))
    _build.require(w_scale, "w_scale", dev, torch.float32, (n,))
    if bias is not None:
        _build.require(bias, "bias", dev, torch.float32, (n,))
    _build.require(a_scale, "a_scale", dev, torch.float32, ())
    _build.require(z_eff, "z_eff", dev, torch.float32, ())
    _build.require(res, "residual", dev, res.dtype, (m, n))
    res_code, out_code = _build.dtype_code(res.dtype), _build.dtype_code(out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    fn = _build.kernel_fn("conv1x1_residual")
    with torch.cuda.device(dev):
        err = fn(_build.ptr(q_a), _build.ptr(w_int), _build.ptr(col_sum),
                 _build.ptr(w_scale), _build.ptr(bias), _build.ptr(a_scale),
                 _build.ptr(z_eff), _build.ptr(res), _build.ptr(out),
                 m, n, k, int(bool(relu)), res_code, out_code, _build.current_stream(dev))
    _build.check(err, "conv1x1_residual")
    conv1x1_residual_gemm.launches += 1
    return out


conv1x1_residual_gemm.launches = 0


def conv1x1_residual(
    q_a: torch.Tensor,          # (N, H, W, K) int8 (already act-quantized)
    z_eff,                      # f32 scalar, shifted-zero convention
    a_scale,                    # f32 scalar
    w_int: torch.Tensor,        # (1, 1, K, Co) or (K, Co) int8, zero w-zero
    w_scale: torch.Tensor,      # (Co,)
    bias: Optional[torch.Tensor],
    residual: torch.Tensor,     # (N, H, W, Co) float
    relu: bool = True,
    col_sum_w: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Fused ``relu(conv1x1(q_a) + residual)`` on the int8 path; matches
    ``quant_conv2d`` (w_zero_is_zero=True, 1x1/stride-1/groups-1) followed by
    the residual add and ReLU."""
    if w_int.ndim == 4:
        w_int = w_int.reshape(w_int.shape[2], w_int.shape[3])
    n, h, w_sp, k = q_a.shape
    co = w_int.shape[1]
    if col_sum_w is None:
        col_sum_w = w_int.sum(dim=0, dtype=torch.int32)
    if out_dtype is None:
        out_dtype = residual.dtype
    dev = q_a.device
    out = conv1x1_residual_gemm(
        q_a.reshape(-1, k).contiguous(),
        torch.as_tensor(z_eff, dtype=torch.float32, device=dev).reshape(()),
        torch.as_tensor(a_scale, dtype=torch.float32, device=dev).reshape(()),
        w_int.contiguous(), col_sum_w.to(torch.int32), w_scale.float().reshape(-1),
        None if bias is None else bias.float(),
        residual.reshape(-1, co).contiguous(), relu, out_dtype)
    return out.reshape(n, h, w_sp, co)
