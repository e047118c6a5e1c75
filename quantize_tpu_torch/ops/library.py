"""The port's kernels as PyTorch custom ops, namespace ``qtt``.

One ``torch.library.custom_op`` for each entry of
:data:`~quantize_tpu_torch.ops.KERNEL_WRAPPERS`, under the same name
(``torch.ops.qtt.w8a8_gemm`` ...), so that ``torch.export`` keeps each
hand-written kernel as one node of the exported graph
(:mod:`quantize_tpu_torch.export`). Each op has

* a CPU and a CUDA implementation: the wrapper, looked up by its
  module-level name at call time (so that a caller that swaps the name, as
  ``chip_smoke.py``'s recorder does, sees the calls of a loaded program
  too). The wrapper's device test does the rest, as in the eager forward:
  a CPU tensor takes the plain version; a CUDA tensor takes the eager
  launch, with the same route choice, the same K-major copies made where
  they are missing, the same launch counters and cost reports, or raises;
* a fake implementation that gives the output's shape and dtype.

No other device has an implementation: a call there raises. The eager
forward does not come here: a wrapper calls its op only while
``torch.compiler.is_exporting()`` is true, so an eager launch pays no
dispatcher. The schemas take tensors, optional tensors, bools, ints,
floats and dtypes; K3's and K3g's strides and padding travel as six ints.
Registering builds nothing.
"""
from __future__ import annotations

import torch

from . import attention, layernorm, qconv, qconv1x1, qmatmul

_GEMM = ("Tensor q_a, Tensor z_eff, Tensor a_scale, Tensor? {w}, Tensor col_sum, Tensor w_scale, "
         "Tensor w_zero, Tensor? bias, bool w_zero_is_zero, Tensor? w_km")
_CONV = ("Tensor q_a, Tensor z_eff, Tensor a_scale, Tensor w_int, Tensor w_scale, Tensor w_zero, "
         "Tensor? bias, int sh, int sw, int pt, int pb, int pl, int pr, Tensor corr_a, "
         "bool w_zero_is_zero, ScalarType out_dtype")
_MHA = "(Tensor qkv, int num_heads, int seq_len, bool causal, ScalarType out_dtype, int valid_len)"


def _conv_unpack(*a) -> tuple:
    """The op's arguments -> the wrapper's (``strides``, ``pads`` rebuilt)."""
    return (*a[:7], (a[7], a[8]), ((a[9], a[10]), (a[11], a[12])), *a[13:])


def _same(*a) -> tuple:
    return a


def _own(out, args):
    """``out`` contiguous, as the fake implementations describe it (the
    kernels' outputs are; a plain version's may follow its input's
    layout). A custom op may not return (a view of) an input: the
    activation quantize's zero point, the second output of KQ and K7, is
    the one it was given where no shift applies, and is copied then."""
    if isinstance(out, tuple):
        q, z = out
        ptr = z.untyped_storage().data_ptr()
        if any(isinstance(a, torch.Tensor) and a.untyped_storage().data_ptr() == ptr
               for a in args):
            z = z.clone()
        return q.contiguous(), z
    return out.contiguous()


def _define(name: str, schema: str, module, wrapper: str, fake, unpack=_same):
    def impl(*args):
        return _own(getattr(module, wrapper)(*unpack(*args)), args)

    op = torch.library.custom_op(f"qtt::{name}", impl, mutates_args=(),
                                 device_types=("cpu", "cuda"), schema=schema)
    op.register_fake(fake)
    return op


def _fake_quantize(x, scale, zero, *_):
    return x.new_empty(x.shape, dtype=torch.int8), zero.new_empty((), dtype=torch.float32)


def _fake_gemm(q_a, z_eff, a_scale, w, col_sum, *_):
    return q_a.new_empty((q_a.shape[0], col_sum.shape[0]), dtype=torch.float32)


def _fake_wo(x, w_int, *_):
    return x.new_empty((x.shape[0], w_int.shape[1]), dtype=torch.float32)


def _fake_conv1x1(q_a, z_eff, a_scale, w_int, col_sum, w_scale, bias, res, relu, out_dtype, w_km):
    return q_a.new_empty((q_a.shape[0], w_int.shape[1]), dtype=out_dtype)


def _fake_conv(q_a, z_eff, a_scale, w_int, w_scale, w_zero, bias, sh, sw, pt, pb, pl, pr,
               corr_a, w_zero_is_zero, out_dtype, *_):
    n, h, w, _ = q_a.shape
    kh, kw, _, co = w_int.shape
    return q_a.new_empty((n, (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1, co),
                         dtype=out_dtype)


def _fake_layernorm(x, scale, bias, eps, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


def _fake_layernorm_quant(x, scale, bias, eps, a_scale, a_zero, *_):
    return x.new_empty(x.shape, dtype=torch.int8), a_zero.new_empty((), dtype=torch.float32)


def _fake_mha(qkv, num_heads, seq_len, causal, out_dtype, valid_len):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1] // 3), dtype=out_dtype)


OPS = {
    "quantize_act_int8": _define(
        "quantize_act_int8", "(Tensor x, Tensor scale, Tensor zero, int qmin, int qmax) "
        "-> (Tensor, Tensor)", qmatmul, "quantize_act_int8", _fake_quantize),
    "w8a8_gemm": _define(
        "w8a8_gemm", f"({_GEMM.format(w='w_int')}) -> Tensor", qmatmul, "w8a8_gemm",
        _fake_gemm),
    "w4a8_gemm": _define(
        "w4a8_gemm", f"({_GEMM.format(w='w_p4')}) -> Tensor", qmatmul, "w4a8_gemm",
        _fake_gemm),
    "wo_gemm": _define(
        "wo_gemm", "(Tensor x, Tensor w_int, Tensor w_scale, Tensor w_zero, Tensor? bias, "
        "ScalarType compute_dtype) -> Tensor", qmatmul, "wo_gemm", _fake_wo),
    "conv1x1_residual": _define(
        "conv1x1_residual", "(Tensor q_a, Tensor z_eff, Tensor a_scale, Tensor w_int, "
        "Tensor col_sum, Tensor w_scale, Tensor? bias, Tensor res, bool relu, "
        "ScalarType out_dtype, Tensor? w_km) -> Tensor", qconv1x1, "conv1x1_residual_gemm",
        _fake_conv1x1),
    "qconv2d": _define(
        "qconv2d", f"({_CONV}, Tensor? w_km) -> Tensor", qconv, "qconv2d_int8",
        _fake_conv, _conv_unpack),
    "qconv2d_grouped": _define(
        "qconv2d_grouped", f"({_CONV}, int groups, Tensor? w_g) -> Tensor", qconv,
        "qconv2d_grouped_int8", _fake_conv, _conv_unpack),
    "layernorm": _define(
        "layernorm", "(Tensor x, Tensor scale, Tensor bias, float eps, ScalarType out_dtype) "
        "-> Tensor", layernorm, "layernorm_rows", _fake_layernorm),
    "layernorm_quant_int8": _define(
        "layernorm_quant_int8", "(Tensor x, Tensor scale, Tensor bias, float eps, "
        "Tensor a_scale, Tensor a_zero, int qmin, int qmax) -> (Tensor, Tensor)", layernorm,
        "layernorm_quant_int8_rows", _fake_layernorm_quant),
    "mha_rows": _define(
        "mha_rows", f"{_MHA} -> Tensor", attention, "mha_rows", _fake_mha),
    "mha_rows_int8": _define(
        "mha_rows_int8", f"{_MHA} -> Tensor", attention, "mha_rows_int8",
        _fake_mha),
}
