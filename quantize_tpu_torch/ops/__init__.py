"""Packed int8 ops. Each hand-written CUDA kernel has a wrapper that
launches it on CUDA tensors (counting launches in ``<wrapper>.launches``)
and a plain PyTorch version that the wrapper runs on CPU tensors:

* K1 :func:`~.qmatmul.w8a8_gemm` (``csrc/w8a8_gemm.cu``)
* K2 :func:`~.qconv1x1.conv1x1_residual_gemm` (``csrc/conv1x1_residual.cu``)
* K3 :func:`~.qconv.qconv2d_int8` (``csrc/qconv2d.cu``)
"""
from .qconv import qconv2d_int8, quant_conv2d
from .qconv1x1 import conv1x1_residual, conv1x1_residual_gemm
from .qmatmul import quant_matmul_w8a8, quantize_act_int8, w8a8_gemm

KERNEL_WRAPPERS = {
    "w8a8_gemm": w8a8_gemm,
    "conv1x1_residual": conv1x1_residual_gemm,
    "qconv2d": qconv2d_int8,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = [
    "KERNEL_WRAPPERS", "conv1x1_residual", "conv1x1_residual_gemm", "launch_counts",
    "qconv2d_int8", "quant_conv2d", "quant_matmul_w8a8", "quantize_act_int8",
    "reset_launch_counts", "w8a8_gemm",
]
