"""Packed int8 ops. Each hand-written CUDA kernel has a wrapper that
launches it on CUDA tensors (counting launches in ``<wrapper>.launches``)
and a plain PyTorch version that the wrapper runs on CPU tensors:

* K1 :func:`~.qmatmul.w8a8_gemm` (``csrc/w8a8_gemm.cu``; its launches by
  route in ``w8a8_gemm.route_launches``)
* K2 :func:`~.qconv1x1.conv1x1_residual_gemm` (``csrc/conv1x1_residual.cu``;
  its launches by route in ``conv1x1_residual_gemm.route_launches``)
* K3 :func:`~.qconv.qconv2d_int8` (``csrc/qconv2d.cu``)
* K3g :func:`~.qconv.qconv2d_grouped_int8` (``csrc/qconv2d_grouped.cu``; the
  grouped int8 conv; its launches by route, tensor-core ``wgmma`` over
  block-diagonal slices or CUDA-core ``dp4a``, in
  ``qconv2d_grouped_int8.route_launches``)
* K4 :func:`~.qmatmul.w4a8_gemm` (``csrc/w4a8_gemm.cu``; its launches by
  route in ``w4a8_gemm.route_launches``)
* K5 :func:`~.qmatmul.wo_gemm` (``csrc/wo_gemm.cu``)
* K6 :func:`~.layernorm.layernorm_rows` (``csrc/layernorm.cu``)
* K7 :func:`~.layernorm.layernorm_quant_int8_rows` (``csrc/layernorm.cu``; its
  launches by route in ``layernorm_quant_int8_rows.route_launches``)
* K8 :func:`~.attention.mha_rows` (``csrc/mha_rows.cu``)
* K9 :func:`~.attention.mha_rows_int8` (``csrc/mha_rows_int8.cu``)
* KQ :func:`~.qmatmul.quantize_act_int8` (``csrc/quantize_act.cu``; the
  activation quantize, an XLA fusion in JAX)
* KA :func:`~.adam.adam_update` (``csrc/adam_update.cu``; the optimizer's
  Adam update of every leaf of a step, :class:`~quantize_tpu_torch.optim.
  Optimizer`'s fused route; a training kernel, not in ``KERNEL_WRAPPERS``)

Importing the package registers each wrapper as a custom op,
``torch.ops.qtt.<name>`` under its ``KERNEL_WRAPPERS`` name
(:mod:`.library`), which the wrappers call only while ``torch.export``
traces them.
"""
from .adam import adam_update
from .attention import mha_fused_qkv, mha_fused_qkv_rows, mha_rows, mha_rows_int8
from .layernorm import layernorm_quant_int8, layernorm_quant_int8_rows, layernorm_rows
from .qconv import qconv2d_grouped_int8, qconv2d_int8, quant_conv2d, quant_conv2d_wo
from .qconv1x1 import conv1x1_residual, conv1x1_residual_gemm
from .qmatmul import (kmajor_packed, pack_int4_splithalf, quant_matmul_w4a8, quant_matmul_w8a8,
                      quant_matmul_wo, quantize_act_int8, unpack_int4_splithalf, w4a8_gemm,
                      w8a8_gemm, wo_gemm)
from . import library  # noqa: F401  (registers the qtt ops)

KERNEL_WRAPPERS = {
    "w8a8_gemm": w8a8_gemm,
    "conv1x1_residual": conv1x1_residual_gemm,
    "qconv2d": qconv2d_int8,
    "qconv2d_grouped": qconv2d_grouped_int8,
    "w4a8_gemm": w4a8_gemm,
    "layernorm": layernorm_rows,
    "layernorm_quant_int8": layernorm_quant_int8_rows,
    "mha_rows": mha_rows,
    "wo_gemm": wo_gemm,
    "mha_rows_int8": mha_rows_int8,
    "quantize_act_int8": quantize_act_int8,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    adam_update.launches = 0
    mha_rows_int8.absmax_launches = 0
    for routes in (w4a8_gemm.route_launches, conv1x1_residual_gemm.route_launches,
                   layernorm_quant_int8_rows.route_launches, w8a8_gemm.route_launches,
                   qconv2d_grouped_int8.route_launches):
        for route in routes:
            routes[route] = 0


def launch_counts() -> dict:
    return {**{name: fn.launches for name, fn in KERNEL_WRAPPERS.items()},
            "adam_update": adam_update.launches}


__all__ = [
    "KERNEL_WRAPPERS", "adam_update", "conv1x1_residual", "conv1x1_residual_gemm", "launch_counts",
    "kmajor_packed", "layernorm_quant_int8", "layernorm_quant_int8_rows", "layernorm_rows",
    "mha_fused_qkv", "mha_fused_qkv_rows", "mha_rows", "mha_rows_int8", "pack_int4_splithalf",
    "qconv2d_grouped_int8", "qconv2d_int8", "quant_conv2d", "quant_conv2d_wo",
    "quant_matmul_w4a8", "quant_matmul_w8a8", "quant_matmul_wo", "quantize_act_int8", "reset_launch_counts", "unpack_int4_splithalf",
    "w4a8_gemm", "w8a8_gemm", "wo_gemm",
]
