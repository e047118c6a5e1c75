"""Quantized matmuls: the activation quantize (kernel KQ), W8A8 (kernel K1),
W4A8 over split-half int4 weights (kernel K4) and the weight-only product
(kernel K5).

PyTorch counterpart of ``quantize_tpu/ops/pallas/qmatmul.py``. Both JAX
backends (the Pallas kernels and the XLA twins) compute

    out = s_a·s_w·(A·W + z_a·colsum(W) + z_w·rowsum(A) + K·z_a·z_w) + bias

over int8 A and int8 (or int4) W with int32 accumulation. Here
:func:`w8a8_gemm` launches the hand-written CUDA kernel ``csrc/w8a8_gemm.cu``
and :func:`w4a8_gemm` launches ``csrc/w4a8_gemm.cu`` on CUDA tensors; on CPU
tensors they run :func:`w8a8_gemm_plain` and :func:`w4a8_gemm_plain`. Both
have two routes, chosen from the shape before launch (:func:`_w8a8_route`,
:func:`_w4a8_route`): a warp-specialized ``wgmma`` kernel over the weights'
K-major copy (:func:`kmajor_packed`, made once at pack time) where K is a
multiple of 16 (K1) or 32 (K4), and the ``mma.sync`` kernel over the
(K, N) or packed (K/2, N) weights for every other K. K1's ``wgmma`` route
splits the K loop across a cluster of CTAs where the output has too few
tiles to fill the card (:func:`_w8a8_split`).

The weight-only product (:func:`quant_matmul_wo`) is float activations
times int8 weights dequantized as ``(w + z)·s``: :func:`wo_gemm` launches
``csrc/wo_gemm.cu`` (the Pallas ``_wo_kernel``'s counterpart, dequantizing
each int8 weight tile once in shared memory) on CUDA tensors and runs
:func:`wo_gemm_plain` on CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..quant.observers import group_unview, group_view
from . import _build, _cost


def quantize_act_int8_plain(x: torch.Tensor, scale, zero, qmin: int, qmax: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel KQ: float -> int8 with the unsigned grid
    shifted into int8 range.

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


@_cost.reports("quantize_act_int8")
def quantize_act_int8(x: torch.Tensor, scale, zero, qmin: int, qmax: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel KQ, the activation quantize of ``quantize_tpu/ops/pallas/
    qmatmul.py:quantize_act_int8`` (an XLA fusion in JAX, no pallas_call):
    ``x`` f32 or bf16 of any shape, per-tensor ``scale`` and ``zero``.
    Returns ``(q_int8, z_eff)`` as :func:`quantize_act_int8_plain`.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/quantize_act.cu`` (one pass, scale and zero read on the device,
    no host sync) or raise.
    """
    dev = x.device
    if torch.compiler.is_exporting():
        return torch.ops.qtt.quantize_act_int8(
            x, torch.as_tensor(scale, dtype=torch.float32, device=dev).reshape(()),
            torch.as_tensor(zero, dtype=torch.float32, device=dev).reshape(()), qmin, qmax)
    if dev.type == "cpu":
        return quantize_act_int8_plain(x, scale, zero, qmin, qmax)
    if dev.type != "cuda":
        raise ValueError(f"quantize_act_int8: unsupported device {dev}")
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    zero = torch.as_tensor(zero, dtype=torch.float32, device=dev)
    if scale.numel() != 1 or zero.numel() != 1:
        raise ValueError("quantize_act_int8: the kernel takes one per-tensor scale and zero, "
                         f"got {scale.numel()} and {zero.numel()} values")
    scale, zero = scale.reshape(()).contiguous(), zero.reshape(()).contiguous()
    in_code = _build.dtype_code(x.dtype)
    x = x.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    fn = _build.kernel_fn("quantize_act_int8")
    with _build.device_guard(dev):
        err = fn(_build.ptr(x), _build.ptr(q), _build.ptr(scale), _build.ptr(zero), x.numel(),
                 int(qmin), int(qmax), in_code, _build.current_stream(dev))
    _build.check(err, "quantize_act_int8")
    quantize_act_int8.launches += 1
    return q, (zero + 128.0 if qmin >= 0 else zero)


quantize_act_int8.launches = 0


def int8_matmul_exact(q_a: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) summed exactly, as float64 (every partial
    sum of int8 products stays far below 2^53). Works on any device."""
    return q_a.double() @ w_int.double()


# K1's wgmma route (``csrc/w8a8_gemm.cu``, namespace wg1): 128 x 128 output
# tiles, stages of 128 K bytes, K split across clusters of at most 8 CTAs
W8A8_BM, W8A8_BN, W8A8_BK, W8A8_MAX_SPLIT = 128, 128, 128, 8


def _w8a8_route(k: int, aligned: bool = True) -> str:
    """Which kernel of ``csrc/w8a8_gemm.cu`` takes an (M, K) x (K, N) launch,
    chosen from the shape before launch: ``"wgmma"`` where K is a positive
    multiple of 16 (the TMA maps of A and the K-major copy need rows of
    16-byte multiples) below 2^17 (the int32 sums) and both are 16-byte
    ``aligned``, else ``"mma_sync"``. M and N are any: TMA zero-fills the
    tiles past them."""
    if 0 < k < 1 << 17 and k % 16 == 0 and aligned:
        return "wgmma"
    return "mma_sync"


def _w8a8_split(m: int, n: int, k: int, sms: int) -> int:
    """How many CTAs of a cluster share one output tile of K1's wgmma route,
    each summing a slice of the K stages: the largest S of 1, 2, 4, 8 with
    tiles x S at most the card's ``sms`` and at least 4 stages for each CTA
    (so that its ring still runs ahead). Large M takes S = 1."""
    tiles = -(-m // W8A8_BM) * -(-n // W8A8_BN)
    nk = -(-k // W8A8_BK)
    s = 1
    while s < W8A8_MAX_SPLIT and tiles * 2 * s <= sms and nk // (2 * s) >= 4:
        s *= 2
    return s


def w8a8_gemm_plain(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                    w_int: Optional[torch.Tensor], col_sum: torch.Tensor, w_scale: torch.Tensor,
                    w_zero: torch.Tensor, bias: Optional[torch.Tensor],
                    w_zero_is_zero: bool, w_km: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel K1 (exact integer sums in float64). The
    weight is ``w_int``, or ``w_km.t()`` where only the K-major copy is
    given."""
    w_int = w_km.t() if w_int is None else w_int
    k = q_a.shape[-1]
    acc = int8_matmul_exact(q_a, w_int).float()
    corrected = acc + z_eff * col_sum.float()[None, :]
    if not w_zero_is_zero:
        rs = q_a.double().sum(-1, keepdim=True).float()
        wz = w_zero.reshape(1, -1)
        corrected = corrected + wz * rs + k * z_eff * wz
    out = a_scale * w_scale.reshape(1, -1) * corrected
    return out if bias is None else out + bias


@_cost.reports("w8a8_gemm")
def w8a8_gemm(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
              w_int: Optional[torch.Tensor], col_sum: torch.Tensor, w_scale: torch.Tensor,
              w_zero: torch.Tensor, bias: Optional[torch.Tensor],
              w_zero_is_zero: bool, w_km: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K1: int8 (M, K) x int8 (K, N) -> f32 (M, N) with the W8A8
    epilogue. ``z_eff`` and ``a_scale`` are 0-d f32 tensors; ``col_sum``
    int32 (N,); ``w_scale``, ``w_zero``, ``bias`` f32 (N,). ``w_km`` is the
    weight's K-major copy (N, K), made beforehand; either weight may be
    None, not both.

    CPU tensors take :func:`w8a8_gemm_plain`; CUDA tensors launch one of the
    two kernels of ``csrc/w8a8_gemm.cu`` (:func:`_w8a8_route`; the launches
    of each are counted in ``w8a8_gemm.route_launches``), making the copy
    the route reads where it was not given, or raise.
    """
    if w_int is None and w_km is None:
        raise ValueError("w8a8_gemm: needs w_int or its K-major copy w_km")
    if torch.compiler.is_exporting():
        return torch.ops.qtt.w8a8_gemm(q_a, z_eff, a_scale, w_int, col_sum, w_scale, w_zero,
                                       bias, bool(w_zero_is_zero), w_km)
    dev = q_a.device
    if dev.type == "cpu":
        return w8a8_gemm_plain(q_a, z_eff, a_scale, w_int, col_sum, w_scale, w_zero,
                               bias, w_zero_is_zero, w_km)
    if dev.type != "cuda":
        raise ValueError(f"w8a8_gemm: unsupported device {dev}")
    m, k = q_a.shape
    n = w_int.shape[1] if w_int is not None else w_km.shape[0]
    aligned = q_a.data_ptr() % 16 == 0 and (w_km is None or w_km.data_ptr() % 16 == 0)
    route = _w8a8_route(k, aligned)
    split = 1
    if route == "wgmma":
        if w_km is None:
            w_km = w_int.t().contiguous()
        _build.require(w_km, "w_km", dev, torch.int8, (n, k))
        w_int = None
        split = _w8a8_split(m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    else:
        if w_int is None:
            w_int = w_km.t().contiguous()
        _build.require(w_int, "w_int", dev, torch.int8, (k, n))
        w_km = None
    _build.require(q_a, "q_a", dev, torch.int8, (m, k))
    _build.require(col_sum, "col_sum", dev, torch.int32, (n,))
    for name, t in (("w_scale", w_scale), ("w_zero", w_zero)):
        _build.require(t, name, dev, torch.float32, (n,))
    if bias is not None:
        _build.require(bias, "bias", dev, torch.float32, (n,))
    _build.require(a_scale, "a_scale", dev, torch.float32, ())
    _build.require(z_eff, "z_eff", dev, torch.float32, ())
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = _build.kernel_fn("w8a8_gemm")
    with _build.device_guard(dev):
        err = fn(_build.ptr(q_a), _build.ptr(w_int), _build.ptr(w_km), _build.ptr(col_sum),
                 _build.ptr(w_scale), _build.ptr(w_zero), _build.ptr(bias),
                 _build.ptr(a_scale), _build.ptr(z_eff), _build.ptr(out),
                 m, n, k, int(bool(w_zero_is_zero)), int(route == "wgmma"), split,
                 _build.current_stream(dev))
    _build.check(err, f"w8a8_gemm ({route})")
    w8a8_gemm.launches += 1
    w8a8_gemm.route_launches[route] += 1
    return out


w8a8_gemm.launches = 0
w8a8_gemm.route_launches = {"wgmma": 0, "mma_sync": 0}


# ---------------------------------------------------------------------------
# W4A8: split-half int4 packing + kernel K4
# ---------------------------------------------------------------------------

def pack_int4_splithalf(q: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 (K, N) into (K/2, N) int8: row r holds row r in the
    low nibble and row r + K/2 in the high nibble. K must be even."""
    k = q.shape[0]
    if k % 2:
        raise ValueError(f"pack_int4_splithalf: K = {k} must be even for split-half int4 packing")
    lo = q[: k // 2].to(torch.int16)
    hi = q[k // 2:].to(torch.int16)
    v = (lo & 0x0F) | ((hi & 0x0F) << 4)
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def unpack_int4_splithalf(p: torch.Tensor) -> torch.Tensor:
    """(K/2, N) split-half nibbles -> (K, N) int8 in [-8, 7]."""
    p16 = p.to(torch.int16)
    lo = ((p16 & 0x0F) ^ 8) - 8
    hi = p16 >> 4
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def kmajor_packed(w: torch.Tensor) -> torch.Tensor:
    """The K-major copy (N, K') of an int8 weight (K', N): of split-half
    packed weights (K/2, N), the layout the ``wgmma`` route of kernel K4
    reads, or of a W8A8 weight (K, N), K1's (8-bit ``wgmma`` reads both
    operands K-major)."""
    return w.t().contiguous()


# K4's wgmma route (``csrc/w4a8_gemm.cu``, namespace wg4): 128 rows a block,
# stages of 64 packed rows (A: two halves of 128 rows x 64 bytes; W: two
# halves of BN rows x 64 bytes), a 4-stage ring
W4A8_BM, W4A8_HALF, W4A8_STAGES = 128, 64, 4


def _w4a8_tile(n: int) -> Tuple[int, int]:
    """``(BN, shared-memory bytes)`` of K4's wgmma route for N output
    columns (``csrc/w4a8_gemm.cu: Tile<BN>::SMEM``): the ring (or the int32
    tile staged over it, rows of BN * 4 + 16 bytes), the full and empty
    barriers, four float32 column vectors, the row sums and 1,024 bytes of
    alignment slack. At most 202,304 bytes, whatever N."""
    bn = 256 if n > 128 else 128 if n > 64 else 64
    stage = 2 * W4A8_BM * W4A8_HALF + 2 * bn * W4A8_HALF
    body = max(W4A8_STAGES * stage, W4A8_BM * (bn * 4 + 16))
    return bn, body + 2 * W4A8_STAGES * 8 + 4 * bn * 4 + W4A8_BM * 4 + 1024


def _w4a8_route(k: int, aligned: bool = True) -> str:
    """Which kernel of ``csrc/w4a8_gemm.cu`` takes an (M, K) x (K/2, N)
    launch, chosen from the shape before launch: ``"wgmma"`` where K is a
    positive multiple of 32 (A's TMA view (M, 2, K/2) needs strides of
    16-byte multiples) below 2^17 (its int32 sums are 16 A.W) and A and the
    K-major copy are 16-byte ``aligned``, else ``"mma_sync"`` (every other
    even K)."""
    if k % 2:
        raise ValueError(f"w4a8_gemm: K = {k} must be even")
    if 0 < k < 1 << 17 and k % 32 == 0 and aligned:
        return "wgmma"
    return "mma_sync"


def w4a8_gemm_plain(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
                    w_p4: Optional[torch.Tensor], col_sum: torch.Tensor, w_scale: torch.Tensor,
                    w_zero: torch.Tensor, bias: Optional[torch.Tensor],
                    w_zero_is_zero: bool, w_km: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of kernel K4: unpack, then K1's exact sums and epilogue
    (``_w4a8_kernel``'s epilogue is ``_w8a8_kernel``'s). The weight is
    ``w_p4``, or ``w_km.t()`` where only the K-major copy is given."""
    w_p4 = w_km.t() if w_p4 is None else w_p4
    return w8a8_gemm_plain(q_a, z_eff, a_scale, unpack_int4_splithalf(w_p4), col_sum,
                           w_scale, w_zero, bias, w_zero_is_zero)


@_cost.reports("w4a8_gemm")
def w4a8_gemm(q_a: torch.Tensor, z_eff: torch.Tensor, a_scale: torch.Tensor,
              w_p4: Optional[torch.Tensor], col_sum: torch.Tensor, w_scale: torch.Tensor,
              w_zero: torch.Tensor, bias: Optional[torch.Tensor],
              w_zero_is_zero: bool, w_km: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K4: int8 (M, K) x split-half int4 (K/2, N) -> f32 (M, N) with
    the W8A8 epilogue. ``col_sum`` is the pack-time int32 column sum of the
    unpacked weight; the other arguments are as :func:`w8a8_gemm`'s.
    ``w_km`` is ``kmajor_packed(w_p4)`` made beforehand; either weight may
    be None, not both.

    CPU tensors take :func:`w4a8_gemm_plain`; CUDA tensors launch one of the
    two kernels of ``csrc/w4a8_gemm.cu`` (:func:`_w4a8_route`; the launches
    of each are counted in ``w4a8_gemm.route_launches``), making the copy
    the route reads where it was not given, or raise.
    """
    if w_p4 is None and w_km is None:
        raise ValueError("w4a8_gemm: needs w_p4 or its K-major copy w_km")
    if torch.compiler.is_exporting():
        return torch.ops.qtt.w4a8_gemm(q_a, z_eff, a_scale, w_p4, col_sum, w_scale, w_zero,
                                       bias, bool(w_zero_is_zero), w_km)
    dev = q_a.device
    if dev.type == "cpu":
        return w4a8_gemm_plain(q_a, z_eff, a_scale, w_p4, col_sum, w_scale, w_zero,
                               bias, w_zero_is_zero, w_km)
    if dev.type != "cuda":
        raise ValueError(f"w4a8_gemm: unsupported device {dev}")
    m, k = q_a.shape
    n = w_p4.shape[1] if w_p4 is not None else w_km.shape[0]
    aligned = q_a.data_ptr() % 16 == 0 and (w_km is None or w_km.data_ptr() % 16 == 0)
    route = _w4a8_route(k, aligned)
    if route == "wgmma":
        if w_km is None:
            w_km = kmajor_packed(w_p4)
        _build.require(w_km, "w_km", dev, torch.int8, (n, k // 2))
        w_p4 = None
    else:
        if w_p4 is None:
            w_p4 = w_km.t().contiguous()
        _build.require(w_p4, "w_p4", dev, torch.int8, (k // 2, n))
        w_km = None
    _build.require(q_a, "q_a", dev, torch.int8, (m, k))
    _build.require(col_sum, "col_sum", dev, torch.int32, (n,))
    for name, t in (("w_scale", w_scale), ("w_zero", w_zero)):
        _build.require(t, name, dev, torch.float32, (n,))
    if bias is not None:
        _build.require(bias, "bias", dev, torch.float32, (n,))
    _build.require(a_scale, "a_scale", dev, torch.float32, ())
    _build.require(z_eff, "z_eff", dev, torch.float32, ())
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = _build.kernel_fn("w4a8_gemm")
    with _build.device_guard(dev):
        err = fn(_build.ptr(q_a), _build.ptr(w_p4), _build.ptr(w_km), _build.ptr(col_sum),
                 _build.ptr(w_scale), _build.ptr(w_zero), _build.ptr(bias),
                 _build.ptr(a_scale), _build.ptr(z_eff), _build.ptr(out),
                 m, n, k, int(bool(w_zero_is_zero)), int(route == "wgmma"),
                 _build.current_stream(dev))
    _build.check(err, f"w4a8_gemm ({route})")
    w4a8_gemm.launches += 1
    w4a8_gemm.route_launches[route] += 1
    return out


w4a8_gemm.launches = 0
w4a8_gemm.route_launches = {"wgmma": 0, "mma_sync": 0}


def _quantized_input(x: torch.Tensor, a_scale, a_zero, a_qmin: int, a_qmax: int, pre_q):
    """``(q_a (M, K) int8, z_eff)`` from ``pre_q`` or by quantizing ``x``."""
    k = x.shape[-1]
    if pre_q is not None:
        q_a, z_eff = pre_q
        return q_a.reshape(-1, k), z_eff
    return quantize_act_int8(x.reshape(-1, k), a_scale, a_zero, a_qmin, a_qmax)


def quant_matmul_w4a8(
    x: torch.Tensor,
    a_scale,
    a_zero,
    a_qmin: int,
    a_qmax: int,
    w_packed: torch.Tensor,
    w_scale: torch.Tensor,
    w_zero: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    col_sum_w: Optional[torch.Tensor] = None,
    w_zero_is_zero: bool = False,
    pre_q=None,
    w_km: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused W4A8 matmul over split-half packed weights ((K/2, N) int8).
    ``x``: (..., K) float (read only for its shape when ``pre_q`` is given).
    ``w_km``: the weights' K-major copy (:func:`kmajor_packed`), made once by
    the caller; ``w_packed`` may then be None."""
    lead = x.shape[:-1]
    n = w_packed.shape[1] if w_packed is not None else w_km.shape[0]
    q_a, z_eff = _quantized_input(x, a_scale, a_zero, a_qmin, a_qmax, pre_q)
    if col_sum_w is None:
        w_p4 = w_packed if w_packed is not None else w_km.t()
        col_sum_w = unpack_int4_splithalf(w_p4).sum(dim=0, dtype=torch.int32)
    a_scale = torch.as_tensor(a_scale, dtype=torch.float32, device=q_a.device).reshape(())
    # positional arguments: chip_smoke.py records the kernels' calls by them
    out = w4a8_gemm(q_a.contiguous(), z_eff.reshape(()), a_scale,
                    None if w_packed is None else w_packed.contiguous(),
                    col_sum_w.to(torch.int32), w_scale.float().reshape(-1),
                    w_zero.float().reshape(-1), None if bias is None else bias.float(),
                    w_zero_is_zero, w_km)
    return out.reshape(*lead, n)


# ---------------------------------------------------------------------------
# Weight-only quantized matmul (float activations)
# ---------------------------------------------------------------------------

def _dequant_weight(w_int: torch.Tensor, w_scale: torch.Tensor, w_zero: torch.Tensor,
                    awq_recip: Optional[torch.Tensor] = None, group_size: int = 0
                    ) -> torch.Tensor:
    """Weight dequant ``(w + z)·s`` of a (K, N) int8 weight in float32, per
    out-channel, or with ``group_size`` > 0 per group: ``w_scale``/``w_zero``
    then hold (N * K/g,) values, groups along K within each out column (the
    AWQ ``q_group_size`` grid). ``awq_recip`` (K,) multiplies row k by
    1/awq_scale[k] (the AWQ deploy layout)."""
    w = w_int.float()
    if group_size:
        s, z = w_scale.float().reshape(-1, 1), w_zero.float().reshape(-1, 1)
        w_deq = group_unview((group_view(w, group_size) + z) * s, w.shape)
    else:
        w_deq = (w + w_zero.float().reshape(1, -1)) * w_scale.float().reshape(1, -1)
    if awq_recip is not None:
        w_deq = w_deq * awq_recip.float().reshape(-1, 1)
    return w_deq


def wo_gemm_plain(x: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor,
                  w_zero: torch.Tensor, bias: Optional[torch.Tensor],
                  compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of kernel K5: the weight dequantized ``(w + z)·s`` in
    float32, both operands rounded to ``compute_dtype``, their products
    formed exactly in float32 (a bf16 x bf16 product fits) and summed in
    float32, then ``+ bias``. Runs on any device (on CUDA with TF32 off)."""
    w_deq = _dequant_weight(w_int, w_scale, w_zero)
    out = x.to(compute_dtype).float() @ w_deq.to(compute_dtype).float()
    return out if bias is None else out + bias


@_cost.reports("wo_gemm")
def wo_gemm(x: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor, w_zero: torch.Tensor,
            bias: Optional[torch.Tensor], compute_dtype: torch.dtype) -> torch.Tensor:
    """Kernel K5: float (M, K) ``x`` (f32 or bf16) times int8 (K, N)
    ``w_int`` dequantized per out-channel by ``w_scale``/``w_zero`` (f32
    (N,)), plus ``bias`` (f32 (N,) or None): f32 (M, N).

    CPU tensors take :func:`wo_gemm_plain`; CUDA tensors launch
    ``csrc/wo_gemm.cu``, which computes in bf16 only, or raise.
    """
    if torch.compiler.is_exporting():
        return torch.ops.qtt.wo_gemm(x, w_int, w_scale, w_zero, bias, compute_dtype)
    dev = x.device
    if dev.type == "cpu":
        return wo_gemm_plain(x, w_int, w_scale, w_zero, bias, compute_dtype)
    if dev.type != "cuda":
        raise ValueError(f"wo_gemm: unsupported device {dev}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"wo_gemm: the kernel computes in bfloat16, not {compute_dtype}")
    m, k = x.shape
    n = w_int.shape[1]
    _build.require(x, "x", dev, x.dtype, (m, k))
    in_code = _build.dtype_code(x.dtype)
    _build.require(w_int, "w_int", dev, torch.int8, (k, n))
    for name, t in (("w_scale", w_scale), ("w_zero", w_zero)):
        _build.require(t, name, dev, torch.float32, (n,))
    if bias is not None:
        _build.require(bias, "bias", dev, torch.float32, (n,))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    fn = _build.kernel_fn("wo_gemm")
    with _build.device_guard(dev):
        err = fn(_build.ptr(x), _build.ptr(w_int), _build.ptr(w_scale), _build.ptr(w_zero),
                 _build.ptr(bias), _build.ptr(out), m, n, k, in_code, _build.current_stream(dev))
    _build.check(err, "wo_gemm")
    wo_gemm.launches += 1
    return out


wo_gemm.launches = 0


def quant_matmul_wo(
    x: torch.Tensor,
    w_int: torch.Tensor,
    w_scale: torch.Tensor,
    w_zero: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    awq_recip: Optional[torch.Tensor] = None,
    group_size: int = 0,
) -> torch.Tensor:
    """Weight-only quantized matmul: float activations x int8-stored weights,
    f32 result, through kernel K5. The operands are bf16 on the card (the
    function the JAX package runs on its accelerator, ``qmatmul.py:462-476``,
    and ``_wo_kernel``'s body for a bf16 operand) and f32 on the CPU.

    The AWQ (``awq_recip``) and grouped (``group_size``) layouts take no
    kernel, as in JAX, whose ``_wo_kernel`` models only per-out-channel
    scales: the weight is dequantized elementwise, then one ``torch.matmul``
    in the same arithmetic (operands rounded to bf16 on the card, their
    products and sums in float32, float32 out)."""
    lead = x.shape[:-1]
    n = w_int.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    cdt = torch.bfloat16 if x2.device.type == "cuda" else torch.float32
    if awq_recip is not None or group_size:
        w_deq = _dequant_weight(w_int, w_scale, w_zero, awq_recip, group_size)
        out = torch.matmul(x2.to(cdt).float(), w_deq.to(cdt).float())
        if bias is not None:
            out = out + bias.float()
        return out.reshape(*lead, n)
    out = wo_gemm(x2.contiguous(), w_int.contiguous(), w_scale.float().reshape(-1),
                  w_zero.float().reshape(-1), None if bias is None else bias.float(), cdt)
    return out.reshape(*lead, n)


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
    w_km: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused W8A8 matmul. ``x``: (..., K) float; ``w_int``: (K, N) int8.
    ``w_km``: the weight's K-major copy (:func:`kmajor_packed`), made once by
    the caller; ``w_int`` may then be None."""
    lead = x.shape[:-1]
    n = w_int.shape[1] if w_int is not None else w_km.shape[0]
    q_a, z_eff = _quantized_input(x, a_scale, a_zero, a_qmin, a_qmax, pre_q)
    if col_sum_w is None:
        w = w_int if w_int is not None else w_km.t()
        col_sum_w = w.sum(dim=0, dtype=torch.int32)
    a_scale = torch.as_tensor(a_scale, dtype=torch.float32, device=q_a.device).reshape(())
    # positional arguments: chip_smoke.py records the kernels' calls by them
    out = w8a8_gemm(q_a.contiguous(), z_eff.reshape(()), a_scale,
                    None if w_int is None else w_int.contiguous(),
                    col_sum_w.to(torch.int32), w_scale.float().reshape(-1),
                    w_zero.float().reshape(-1), None if bias is None else bias.float(),
                    w_zero_is_zero, w_km)
    return out.reshape(*lead, n)


def quant_matmul_w8a8_xla(x: torch.Tensor, a_scale, a_zero, a_qmin: int, a_qmax: int,
                          w_int: torch.Tensor, w_scale: torch.Tensor, w_zero: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          col_sum_w: Optional[torch.Tensor] = None,
                          w_zero_is_zero: bool = False, pre_q=None) -> torch.Tensor:
    """Kernel K1's math as plain PyTorch under JAX's name for its XLA twin
    (``quantize_tpu/ops/pallas/qmatmul.py:517``): the activation quantize
    (:func:`quantize_act_int8_plain`, or ``pre_q``), exact integer sums and
    the zero-point/scale/bias epilogue (:func:`w8a8_gemm_plain`), on any
    device. The packed path does not call it: it launches the kernel
    (:func:`quant_matmul_w8a8`)."""
    lead, k = x.shape[:-1], x.shape[-1]
    if pre_q is not None:
        q_a, z_eff = pre_q
        q_a = q_a.reshape(-1, k)
    else:
        q_a, z_eff = quantize_act_int8_plain(x.reshape(-1, k), a_scale, a_zero, a_qmin, a_qmax)
    if col_sum_w is None:
        col_sum_w = w_int.sum(dim=0, dtype=torch.int32)
    a_scale = torch.as_tensor(a_scale, dtype=torch.float32, device=q_a.device)
    out = w8a8_gemm_plain(q_a, torch.as_tensor(z_eff, dtype=torch.float32), a_scale, w_int,
                          col_sum_w, w_scale.float(), w_zero.float(),
                          None if bias is None else bias.float(), w_zero_is_zero)
    return out.reshape(*lead, w_int.shape[1])
