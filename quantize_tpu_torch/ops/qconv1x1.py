"""Fused 1x1-conv + residual-add + ReLU for packed CNN blocks: kernel K2.

PyTorch counterpart of ``quantize_tpu/ops/pallas/qconv1x1.py``. A stride-1
1x1 conv is a matmul over M = N·H·W rows, so the whole bottleneck tail is
one kernel:

    out = relu( s_a·s_w_c·(A_q·W_q + z_a·colsum_c(W_q)) + bias_c + residual )

reading the int8 activation and the residual once and writing the
carry-dtype output once. Weight zero points must be exactly zero.
:func:`conv1x1_residual_gemm` launches ``csrc/conv1x1_residual.cu`` on CUDA
tensors (a persistent ``wgmma`` kernel over the weight's K-major copy where
the shape allows it, :func:`_conv1x1_route`, else an ``mma.sync`` kernel)
and runs :func:`conv1x1_residual_plain` on CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, _cost
from .qmatmul import int8_matmul_exact


# K2's wgmma route (``csrc/conv1x1_residual.cu``, namespace wg2): 128 x 128
# output tiles, stages of 128 K bytes (16 KB of A, 16 KB of W), two
# residual/output buffers of a tile each in the wider of the two dtypes,
# as many stages (2-4) as fit in 227 KB, a tail of barriers and columns
CONV1X1_BM, CONV1X1_BN, CONV1X1_BK = 128, 128, 128
_SMEM_LIMIT = 232448
_TAIL = 128 + 2 * 3 * CONV1X1_BN * 4


def _conv1x1_smem(res_itemsize: int, out_itemsize: int) -> Tuple[int, int]:
    """``(ring stages, shared-memory bytes)`` of K2's wgmma route for the
    residual and output item sizes (``csrc/conv1x1_residual.cu:
    Tile::STAGES, Tile::SMEM``). Neither depends on M, N or K."""
    stage = CONV1X1_BM * CONV1X1_BK + CONV1X1_BN * CONV1X1_BK
    buf = CONV1X1_BM * CONV1X1_BN * max(res_itemsize, out_itemsize)
    stages = min(4, (_SMEM_LIMIT - 1024 - 2 * buf - _TAIL) // stage)
    return stages, stages * stage + 2 * buf + _TAIL + 1024


def _conv1x1_route(k: int, n: int, aligned: bool = True, itemsize: int = 4) -> str:
    """Which kernel of ``csrc/conv1x1_residual.cu`` takes an (M, K) x (K, N)
    launch, chosen from the shape before launch: ``"wgmma"`` where K is a
    positive multiple of 16 (A's and the K-major weight's TMA rows are K
    bytes, a multiple of 16) below 2^17 (the int32 sums of K products of at
    most 2^14 cannot overflow), N * ``itemsize`` (the narrower of the
    residual's and the output's item sizes) is a multiple of 16 bytes (their
    TMA rows), and A, the K-major weight, the residual and the output are
    16-byte ``aligned``; else ``"mma_sync"``."""
    if 0 < k < 1 << 17 and k % 16 == 0 and n * itemsize % 16 == 0 and aligned:
        return "wgmma"
    return "mma_sync"


def conv1x1_residual_plain(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                           w_int: torch.Tensor, col_sum: torch.Tensor,
                           w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                           res: torch.Tensor, relu: bool, out_dtype: torch.dtype,
                           w_km: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel K2 over 2-D (M, K) / (M, N) operands; the
    residual is added in f32 before the one cast to ``out_dtype``. It takes
    the kernel's arguments; ``w_km``, the weight's K-major copy, is not
    read."""
    acc = int8_matmul_exact(q_a, w_int).float()
    out = a_scale * w_scale.reshape(1, -1) * (acc + z_eff * col_sum.float()[None, :])
    if bias is not None:
        out = out + bias
    out = out + res.float()
    if relu:
        out = torch.clamp_min(out, 0.0)
    return out.to(out_dtype)


@_cost.reports("conv1x1_residual")
def conv1x1_residual_gemm(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                          w_int: torch.Tensor, col_sum: torch.Tensor,
                          w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                          res: torch.Tensor, relu: bool, out_dtype: torch.dtype,
                          w_km: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K2 on 2-D operands: q_a int8 (M, K), w_int int8 (K, N), col_sum
    int32 (N,), res f32/bf16 (M, N); returns (M, N) in ``out_dtype``.
    ``w_km`` is the K-major copy (N, K) of ``w_int`` made beforehand
    (``QuantConv.w_kmajor``), or None.

    CPU tensors take :func:`conv1x1_residual_plain`; CUDA tensors launch one
    of the two kernels of ``csrc/conv1x1_residual.cu`` (:func:`_conv1x1_route`;
    the launches of each are counted in
    ``conv1x1_residual_gemm.route_launches``), the wgmma route making the
    K-major copy where it was not given, or raise. A failure on either route
    raises; nothing is retried on the other route or on the CPU.
    """
    if torch.compiler.is_exporting():
        return torch.ops.qtt.conv1x1_residual(q_a, z_eff, a_scale, w_int, col_sum, w_scale,
                                              bias, res, bool(relu), out_dtype, w_km)
    dev = q_a.device
    if dev.type == "cpu":
        return conv1x1_residual_plain(q_a, z_eff, a_scale, w_int, col_sum, w_scale, bias,
                                      res, relu, out_dtype, w_km)
    if dev.type != "cuda":
        raise ValueError(f"conv1x1_residual: unsupported device {dev}")
    m, k = q_a.shape
    n = w_int.shape[1]
    res_code, out_code = _build.dtype_code(res.dtype), _build.dtype_code(out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q_a, res, out)) and (
        w_km is None or w_km.data_ptr() % 16 == 0)
    route = _conv1x1_route(k, n, aligned, min(res.element_size(), out.element_size()))
    if route == "wgmma":
        if w_km is None:
            w_km = w_int.t().contiguous()
        _build.require(w_km, "w_km", dev, torch.int8, (n, k))
    else:
        if -(-m // 128) > 65535:
            raise ValueError(f"conv1x1_residual: M = {m} rows at K = {k}, N = {n} exceed the "
                             f"mma_sync kernel's grid (65,535 tiles of 128 rows) and the shape "
                             f"does not take the wgmma route")
        w_km = None
    _build.require(w_int, "w_int", dev, torch.int8, (k, n))
    _build.require(q_a, "q_a", dev, torch.int8, (m, k))
    _build.require(col_sum, "col_sum", dev, torch.int32, (n,))
    _build.require(w_scale, "w_scale", dev, torch.float32, (n,))
    if bias is not None:
        _build.require(bias, "bias", dev, torch.float32, (n,))
    _build.require(a_scale, "a_scale", dev, torch.float32, ())
    _build.require(z_eff, "z_eff", dev, torch.float32, ())
    _build.require(res, "residual", dev, res.dtype, (m, n))
    fn = _build.kernel_fn("conv1x1_residual")
    with _build.device_guard(dev):
        err = fn(_build.ptr(q_a), _build.ptr(w_int), _build.ptr(w_km), _build.ptr(col_sum),
                 _build.ptr(w_scale), _build.ptr(bias), _build.ptr(a_scale),
                 _build.ptr(z_eff), _build.ptr(res), _build.ptr(out),
                 m, n, k, int(bool(relu)), res_code, out_code, int(route == "wgmma"),
                 _build.current_stream(dev))
    _build.check(err, f"conv1x1_residual ({route})")
    conv1x1_residual_gemm.launches += 1
    conv1x1_residual_gemm.route_launches[route] += 1
    return out


conv1x1_residual_gemm.launches = 0
conv1x1_residual_gemm.route_launches = {"wgmma": 0, "mma_sync": 0}


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
    w_km: Optional[torch.Tensor] = None,  # (Co, K) K-major copy, ops.qconv.kmajor_weight
) -> torch.Tensor:
    """Fused ``relu(conv1x1(q_a) + residual)`` on the int8 path; matches
    ``quant_conv2d`` (w_zero_is_zero=True, 1x1/stride-1/groups-1) followed by
    the residual add and ReLU. ``w_km``, the weight's K-major copy made once
    by the caller, is what K2's wgmma route reads."""
    if w_int.ndim == 4:
        w_int = w_int.reshape(w_int.shape[2], w_int.shape[3])
    n, h, w_sp, k = q_a.shape
    co = w_int.shape[1]
    if col_sum_w is None:
        col_sum_w = w_int.sum(dim=0, dtype=torch.int32)
    if out_dtype is None:
        out_dtype = residual.dtype
    dev = q_a.device
    # positional arguments: chip_smoke.py records the kernels' calls by them
    out = conv1x1_residual_gemm(
        q_a.reshape(-1, k).contiguous(),
        torch.as_tensor(z_eff, dtype=torch.float32, device=dev).reshape(()),
        torch.as_tensor(a_scale, dtype=torch.float32, device=dev).reshape(()),
        w_int.contiguous(), col_sum_w.to(torch.int32), w_scale.float().reshape(-1),
        None if bias is None else bias.float(),
        residual.reshape(-1, co).contiguous(), relu, out_dtype, w_km)
    return out.reshape(n, h, w_sp, co)
