"""W8A8 quantized matmul: activation quantize + kernel K1.

PyTorch counterpart of the W8A8 part of ``quantize_tpu/ops/pallas/qmatmul.py``.
Both JAX backends (the Pallas ``_w8a8_kernel`` and the XLA twin
``quant_matmul_w8a8_xla``) compute

    out = s_a·s_w·(A·W + z_a·colsum(W) + z_w·rowsum(A) + K·z_a·z_w) + bias

over int8 A and W with int32 accumulation; here :func:`w8a8_gemm` launches
the hand-written CUDA kernel ``csrc/w8a8_gemm.cu`` on CUDA tensors and runs
:func:`w8a8_gemm_plain` on CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build


def quantize_act_int8(x: torch.Tensor, scale, zero, qmin: int, qmax: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float -> int8 with the unsigned grid shifted into int8 range.

    Returns ``(q_int8, effective_zero_f32)``. The grid index is computed in
    f32 with a true division (as JAX does), also for bf16 inputs: bf16's
    8-bit mantissa would move round() decisions near half-integers.
    """
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    z_eff = torch.as_tensor(zero, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x.float() / scale - z_eff), qmin, qmax)
    if qmin >= 0:
        q = q - 128.0
        z_eff = z_eff + 128.0
    return q.to(torch.int8), z_eff


def int8_matmul_exact(q_a: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) summed exactly, as float64 (every partial
    sum of int8 products stays far below 2^53). Works on any device."""
    return q_a.double() @ w_int.double()


def w8a8_gemm_plain(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                    w_int: torch.Tensor, col_sum: torch.Tensor, w_scale: torch.Tensor,
                    w_zero: torch.Tensor, bias: Optional[torch.Tensor],
                    w_zero_is_zero: bool) -> torch.Tensor:
    """Plain version of kernel K1 (exact integer sums in float64)."""
    k = q_a.shape[-1]
    acc = int8_matmul_exact(q_a, w_int).float()
    corrected = acc + z_eff * col_sum.float()[None, :]
    if not w_zero_is_zero:
        rs = q_a.double().sum(-1, keepdim=True).float()
        wz = w_zero.reshape(1, -1)
        corrected = corrected + wz * rs + k * z_eff * wz
    out = a_scale * w_scale.reshape(1, -1) * corrected
    return out if bias is None else out + bias


def w8a8_gemm(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
              w_int: torch.Tensor, col_sum: torch.Tensor, w_scale: torch.Tensor,
              w_zero: torch.Tensor, bias: Optional[torch.Tensor],
              w_zero_is_zero: bool) -> torch.Tensor:
    """Kernel K1: int8 (M, K) x int8 (K, N) -> f32 (M, N) with the W8A8
    epilogue. ``z_eff`` and ``a_scale`` are 0-d f32 tensors; ``col_sum``
    int32 (N,); ``w_scale``, ``w_zero``, ``bias`` f32 (N,).

    CPU tensors take :func:`w8a8_gemm_plain`; CUDA tensors launch the kernel
    (``csrc/w8a8_gemm.cu``) or raise.
    """
    dev = q_a.device
    if dev.type == "cpu":
        return w8a8_gemm_plain(q_a, z_eff, a_scale, w_int, col_sum, w_scale, w_zero,
                               bias, w_zero_is_zero)
    if dev.type != "cuda":
        raise ValueError(f"w8a8_gemm: unsupported device {dev}")
    m, k = q_a.shape
    n = w_int.shape[1]
    _build.require(q_a, "q_a", dev, torch.int8, (m, k))
    _build.require(w_int, "w_int", dev, torch.int8, (k, n))
    _build.require(col_sum, "col_sum", dev, torch.int32, (n,))
    for name, t in (("w_scale", w_scale), ("w_zero", w_zero)):
        _build.require(t, name, dev, torch.float32, (n,))
    if bias is not None:
        _build.require(bias, "bias", dev, torch.float32, (n,))
    _build.require(a_scale, "a_scale", dev, torch.float32, ())
    _build.require(z_eff, "z_eff", dev, torch.float32, ())
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = _build.kernel_fn("w8a8_gemm")
    with torch.cuda.device(dev):
        err = fn(_build.ptr(q_a), _build.ptr(w_int), _build.ptr(col_sum),
                 _build.ptr(w_scale), _build.ptr(w_zero), _build.ptr(bias),
                 _build.ptr(a_scale), _build.ptr(z_eff), _build.ptr(out),
                 m, n, k, int(bool(w_zero_is_zero)), _build.current_stream(dev))
    _build.check(err, "w8a8_gemm")
    w8a8_gemm.launches += 1
    return out


w8a8_gemm.launches = 0


def quant_matmul_w8a8(
    x: torch.Tensor,
    a_scale,
    a_zero,
    a_qmin: int,
    a_qmax: int,
    w_int: torch.Tensor,
    w_scale: torch.Tensor,
    w_zero: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    col_sum_w: Optional[torch.Tensor] = None,
    w_zero_is_zero: bool = False,
    pre_q=None,
) -> torch.Tensor:
    """Fused W8A8 matmul. ``x``: (..., K) float; ``w_int``: (K, N) int8."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w_int.shape[1]
    if pre_q is not None:
        q_a, z_eff = pre_q
        q_a = q_a.reshape(-1, k)
    else:
        q_a, z_eff = quantize_act_int8(x.reshape(-1, k), a_scale, a_zero, a_qmin, a_qmax)
    if col_sum_w is None:
        col_sum_w = w_int.sum(dim=0, dtype=torch.int32)
    a_scale = torch.as_tensor(a_scale, dtype=torch.float32, device=x.device).reshape(())
    out = w8a8_gemm(q_a.contiguous(), z_eff.reshape(()), a_scale, w_int.contiguous(),
                    col_sum_w.to(torch.int32), w_scale.float().reshape(-1),
                    w_zero.float().reshape(-1), None if bias is None else bias.float(),
                    w_zero_is_zero)
    return out.reshape(*lead, n)
