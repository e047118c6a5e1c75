"""Fused LayerNorm kernels: K6 (:func:`layernorm`) and K7
(:func:`layernorm_quant_int8`, LayerNorm fused with the consumer's int8
activation quantize).

PyTorch counterpart of ``quantize_tpu/ops/pallas/layernorm.py``. On CUDA
tensors the wrappers launch the hand-written kernels of
``csrc/layernorm.cu``; on CPU tensors they run the plain versions below.
Both follow :func:`_ln_math`: float32 statistics whatever the carry dtype,
with the two row sums taken in float64 and rounded to float32 once and
``1/sqrt`` as IEEE square root and division. That makes every step
independent of the summation order, so kernel and plain version agree bit
for bit; the JAX package sums in float32 and uses ``rsqrt``, so the port
differs from it by float32 reassociation (one or two ulp of the statistics).

K7 has two routes, chosen from the shape before launch (:func:`_ln_q_route`)
and counted in ``layernorm_quant_int8_rows.route_launches``: the ``vector``
kernel holds a row in registers (d a multiple of 128 up to 2,048, as every
ViT and CLIP width of the zoo), the ``scalar`` kernel takes every other d.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .qmatmul import quantize_act_int8_plain


def _ln_math(x32: torch.Tensor, g32: torch.Tensor, b32: torch.Tensor, eps: float) -> torch.Tensor:
    """``(xc * (1/sqrt(var + eps))) * g + b`` over the last axis, float32.

    ``d`` divides as a tensor: on CUDA PyTorch turns a division by a Python
    scalar into a multiplication by its float32 reciprocal."""
    d = torch.tensor(float(x32.shape[-1]), dtype=torch.float32, device=x32.device)
    mu = x32.double().sum(dim=-1, keepdim=True).float() / d
    xc = x32 - mu
    var = (xc * xc).double().sum(dim=-1, keepdim=True).float() / d
    return xc * torch.reciprocal(torch.sqrt(var + eps)) * g32 + b32


def _rows(x: torch.Tensor):
    d = x.shape[-1]
    return x.reshape(-1, d), x.shape[:-1], d


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of kernel K6 over (R, d) rows."""
    return _ln_math(x.float(), scale.float(), bias.float(), eps).to(out_dtype)


def layernorm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel K6 on (R, d) rows: CPU tensors take :func:`layernorm_plain`;
    CUDA tensors launch ``csrc/layernorm.cu`` or raise."""
    dev = x.device
    if dev.type == "cpu":
        return layernorm_plain(x, scale, bias, eps, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"layernorm: unsupported device {dev}")
    r, d = x.shape
    in_code, out_code = _build.dtype_code(x.dtype), _build.dtype_code(out_dtype)
    _build.require(x, "x", dev, x.dtype, (r, d))
    _build.require(scale, "scale", dev, torch.float32, (d,))
    _build.require(bias, "bias", dev, torch.float32, (d,))
    out = torch.empty((r, d), dtype=out_dtype, device=dev)
    fn = _build.kernel_fn("layernorm")
    with _build.device_guard(dev):
        err = fn(_build.ptr(x), _build.ptr(scale), _build.ptr(bias), _build.ptr(out), r, d,
                 float(eps), in_code, out_code, _build.current_stream(dev))
    _build.check(err, "layernorm")
    layernorm_rows.launches += 1
    return out


layernorm_rows.launches = 0


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6,
              out_dtype=None) -> torch.Tensor:
    """Fused LayerNorm over the last axis. float32 statistics regardless of
    the carry dtype; the result in ``out_dtype`` (default: ``x``'s)."""
    out_dtype = out_dtype or x.dtype
    x2, lead, d = _rows(x)
    out = layernorm_rows(x2.contiguous(), scale.float().contiguous(),
                         bias.float().contiguous(), eps, out_dtype)
    return out.reshape(*lead, d)


# K7's vector route (csrc/layernorm.cu: ln_q_vec_kernel): a row of d = 128 * nv
# elements in registers, nv loads of four elements a lane, nv <= 16
LN_Q_VEC_MAX_D = 2048


def _ln_q_route(d: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """Which kernel of ``csrc/layernorm.cu`` takes a K7 launch over rows of
    ``d`` elements of ``dtype`` (float32 or bfloat16; others raise), chosen
    before launch: ``"vector"`` where d is a positive multiple of 128 up to
    2,048 and x is ``aligned`` to the kernel's four-element loads (16 bytes
    in float32, 8 in bf16), else ``"scalar"``."""
    _build.dtype_code(dtype)
    if 0 < d <= LN_Q_VEC_MAX_D and d % 128 == 0 and aligned:
        return "vector"
    return "scalar"


def layernorm_quant_int8_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                               eps: float, a_scale: torch.Tensor, a_zero: torch.Tensor,
                               qmin: int, qmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel K7 over (R, d) rows: :func:`_ln_math`, then
    the plain activation quantize
    (:func:`~quantize_tpu_torch.ops.qmatmul.quantize_act_int8_plain`), so it
    launches no kernel on the card either."""
    y = _ln_math(x.float(), scale.float(), bias.float(), eps)
    return quantize_act_int8_plain(y, a_scale, a_zero, qmin, qmax)


def layernorm_quant_int8_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                              eps: float, a_scale: torch.Tensor, a_zero: torch.Tensor,
                              qmin: int, qmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K7 on (R, d) rows; ``a_scale`` and ``a_zero`` are 0-d float32
    tensors. Returns ``(q int8 (R, d), z_eff)`` with ``z_eff`` a 0-d tensor
    on the device (no host sync). CUDA tensors launch the kernel of
    ``csrc/layernorm.cu`` that :func:`_ln_q_route` picks, or raise."""
    dev = x.device
    if dev.type == "cpu":
        return layernorm_quant_int8_plain(x, scale, bias, eps, a_scale, a_zero, qmin, qmax)
    if dev.type != "cuda":
        raise ValueError(f"layernorm_quant_int8: unsupported device {dev}")
    r, d = x.shape
    in_code = _build.dtype_code(x.dtype)
    _build.require(x, "x", dev, x.dtype, (r, d))
    _build.require(scale, "scale", dev, torch.float32, (d,))
    _build.require(bias, "bias", dev, torch.float32, (d,))
    _build.require(a_scale, "a_scale", dev, torch.float32, ())
    _build.require(a_zero, "a_zero", dev, torch.float32, ())
    aligned = (x.data_ptr() % (4 * x.element_size()) == 0
               and scale.data_ptr() % 16 == 0 and bias.data_ptr() % 16 == 0)
    route = _ln_q_route(d, x.dtype, aligned)
    q = torch.empty((r, d), dtype=torch.int8, device=dev)
    fn = _build.kernel_fn("layernorm_quant_int8")
    with _build.device_guard(dev):
        err = fn(_build.ptr(x), _build.ptr(scale), _build.ptr(bias), _build.ptr(a_scale),
                 _build.ptr(a_zero), _build.ptr(q), r, d, float(eps), int(qmin), int(qmax),
                 in_code, int(route == "vector"), _build.current_stream(dev))
    _build.check(err, f"layernorm_quant_int8 ({route})")
    layernorm_quant_int8_rows.launches += 1
    layernorm_quant_int8_rows.route_launches[route] += 1
    z_eff = a_zero + 128.0 if qmin >= 0 else a_zero.clone()
    return q, z_eff


layernorm_quant_int8_rows.launches = 0
layernorm_quant_int8_rows.route_launches = {"vector": 0, "scalar": 0}


def layernorm_quant_int8(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                         a_scale, a_zero, qmin: int, qmax: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm fused with int8 activation quantization.

    Returns ``(q_int8, z_eff)`` with exactly the
    :func:`~quantize_tpu_torch.ops.qmatmul.quantize_act_int8` convention, so
    the result feeds ``quant_matmul_*(..., pre_q=(q, z_eff))`` directly.
    """
    x2, lead, d = _rows(x)
    dev = x.device
    a_scale = torch.as_tensor(a_scale, dtype=torch.float32, device=dev).reshape(())
    a_zero = torch.as_tensor(a_zero, dtype=torch.float32, device=dev).reshape(())
    q, z_eff = layernorm_quant_int8_rows(x2.contiguous(), scale.float().contiguous(),
                                         bias.float().contiguous(), eps, a_scale, a_zero,
                                         qmin, qmax)
    return q.reshape(*lead, d), z_eff
