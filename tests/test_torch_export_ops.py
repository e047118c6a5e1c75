"""The ``qtt`` custom ops (``quantize_tpu_torch/ops/library.py``) alone.

``torch.library.opcheck`` holds each of the eleven ops to its schema, its
fake implementation (shape, dtype and strides of the real output) and the
dispatcher's tracing, at small shapes with its optional-argument cases:
a bias or none, only the K-major weight copy, bf16 in and out, causal and
padded attention, the activation quantize with and without its unsigned
shift (where it returns the zero point it was given, which the op copies).
Each op's result is also held bit for bit against the wrapper it stands
for, called directly. On the CPU the ops run the plain versions; the same
cases run on the card under the ``cuda`` marker (this file imports no JAX,
so it runs there with ``--noconftest``), where each op call also launches
its kernel once, on the route the wrapper picks.
"""
import pytest
import torch

import quantize_tpu_torch  # noqa: F401  (registers the qtt ops)
from quantize_tpu_torch.ops import KERNEL_WRAPPERS, launch_counts
from quantize_tpu_torch.ops.qconv import (conv_zero_correction_map, grouped_kernel_weight,
                                          kmajor_weight)
from quantize_tpu_torch.ops.qmatmul import kmajor_packed, pack_int4_splithalf

torch.set_num_threads(2)

F32, BF16 = torch.float32, torch.bfloat16


def _ints(g, shape, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=g).to(torch.int8)


def _scalars(zero=3.0):
    return torch.tensor(zero), torch.tensor(0.02)


def _gemm(g, four_bit, given, bias, wz0):
    m, k, n = 8, 64, 32
    q = _ints(g, (m, k))
    w = _ints(g, (k, n), -8, 8) if four_bit else _ints(g, (k, n))
    stored = pack_int4_splithalf(w) if four_bit else w
    w_km = kmajor_packed(stored)
    z, s = _scalars()
    vec = torch.rand(n, generator=g) + 0.5
    w_zero = torch.zeros(n) if wz0 else torch.randn(n, generator=g)
    return (q, z, s, stored if "w" in given else None, w.sum(0, dtype=torch.int32), vec, w_zero,
            torch.randn(n, generator=g) if bias else None, wz0,
            w_km if "km" in given else None)


def _conv(g, grouped, stride, pads, out_dtype, bias, wz0, with_copy):
    ci, co, groups = (64, 64, 16) if grouped == "wgmma" else (16, 16, 4) if grouped else (16, 32, 1)
    q = _ints(g, (2, 6, 6, ci))
    w = _ints(g, (3, 3, ci // groups, co))
    z, s = _scalars()
    corr = conv_zero_correction_map(w, 6, 6, (stride, stride), pads)
    copy = (grouped_kernel_weight(w, groups) if grouped else kmajor_weight(w)) if with_copy else None
    (pt, pb), (pl, pr) = pads
    head = (q, z, s, w, torch.rand(co, generator=g) + 0.5,
            torch.zeros(co) if wz0 else torch.randn(co, generator=g),
            torch.randn(co, generator=g) if bias else None)
    tail = (corr, wz0, out_dtype) + ((groups,) if grouped else ()) + (copy,)
    return (head + (stride, stride, pt, pb, pl, pr) + tail,
            head + ((stride, stride), pads) + tail)


def _conv1x1(g, res_dtype, out_dtype, bias, relu, with_copy):
    m, k, n = 16, 64, 32
    q, w = _ints(g, (m, k)), _ints(g, (k, n))
    z, s = _scalars()
    return (q, z, s, w, w.sum(0, dtype=torch.int32), torch.rand(n, generator=g) + 0.5,
            torch.randn(n, generator=g) if bias else None,
            torch.randn(m, n, generator=g).to(res_dtype), relu, out_dtype,
            w.t().contiguous() if with_copy else None)


def _attention(g, dtype, causal, valid):
    return (torch.randn(16, 192, generator=g).to(dtype), 2, 8, causal, dtype, valid)


def _same(args):
    return args, args


# (id, op, a function of a generator giving (op arguments, wrapper arguments))
OP_CASES = [
    ("kq_f32_unsigned", "quantize_act_int8",
     lambda g: _same((torch.randn(8, 32, generator=g), *_scalars(), 0, 255))),
    ("kq_bf16_signed", "quantize_act_int8",
     lambda g: _same((torch.randn(8, 32, generator=g).to(BF16), *_scalars(0.0), -128, 127))),
    ("k1_w_int_bias", "w8a8_gemm", lambda g: _same(_gemm(g, False, ("w",), True, True))),
    ("k1_w_km_only", "w8a8_gemm", lambda g: _same(_gemm(g, False, ("km",), False, False))),
    ("k4_w_p4_bias", "w4a8_gemm", lambda g: _same(_gemm(g, True, ("w", "km"), True, True))),
    ("k4_w_km_only", "w4a8_gemm", lambda g: _same(_gemm(g, True, ("km",), False, False))),
    ("k5_f32_bias", "wo_gemm",
     lambda g: _same((torch.randn(8, 64, generator=g), _ints(g, (64, 32)),
                      torch.rand(32, generator=g) / 64, torch.randn(32, generator=g),
                      torch.randn(32, generator=g), BF16))),
    ("k5_bf16_no_bias", "wo_gemm",
     lambda g: _same((torch.randn(8, 64, generator=g).to(BF16), _ints(g, (64, 32)),
                      torch.rand(32, generator=g) / 64, torch.zeros(32), None, BF16))),
    ("k2_f32_relu_copy", "conv1x1_residual",
     lambda g: _same(_conv1x1(g, F32, F32, True, True, True))),
    ("k2_bf16_no_bias", "conv1x1_residual",
     lambda g: _same(_conv1x1(g, BF16, BF16, False, False, False))),
    ("k3_bias_copy", "qconv2d",
     lambda g: _conv(g, None, 1, ((1, 1), (1, 1)), F32, True, True, True)),
    ("k3_bf16_stride2_wz", "qconv2d",
     lambda g: _conv(g, None, 2, ((0, 1), (0, 1)), BF16, False, False, False)),
    ("k3g_dp4a", "qconv2d_grouped",
     lambda g: _conv(g, "dp4a", 1, ((1, 1), (1, 1)), F32, True, True, False)),
    ("k3g_wgmma_bf16", "qconv2d_grouped",
     lambda g: _conv(g, "wgmma", 1, ((1, 1), (1, 1)), BF16, False, False, True)),
    ("k6_f32", "layernorm",
     lambda g: _same((torch.randn(8, 128, generator=g), torch.rand(128, generator=g) + 0.5,
                      torch.randn(128, generator=g), 1e-6, F32))),
    ("k6_bf16", "layernorm",
     lambda g: _same((torch.randn(8, 128, generator=g).to(BF16),
                      torch.rand(128, generator=g) + 0.5, torch.randn(128, generator=g),
                      1e-5, BF16))),
    ("k7_vector_unsigned", "layernorm_quant_int8",
     lambda g: _same((torch.randn(8, 128, generator=g), torch.rand(128, generator=g) + 0.5,
                      torch.randn(128, generator=g), 1e-6, *_scalars()[::-1], 0, 255))),
    ("k7_scalar_bf16_signed", "layernorm_quant_int8",
     lambda g: _same((torch.randn(8, 96, generator=g).to(BF16),
                      torch.rand(96, generator=g) + 0.5, torch.randn(96, generator=g), 1e-6,
                      torch.tensor(0.02), torch.tensor(0.0), -128, 127))),
    ("k8_f32", "mha_rows", lambda g: _same(_attention(g, F32, False, 0))),
    ("k8_bf16_causal_padded", "mha_rows", lambda g: _same(_attention(g, BF16, True, 5))),
    ("k9_f32", "mha_rows_int8", lambda g: _same(_attention(g, F32, False, 0))),
    ("k9_bf16_causal_padded", "mha_rows_int8", lambda g: _same(_attention(g, BF16, True, 5))),
]


def _to(args, device):
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def run_case(case, device):
    """opcheck, then the op against its wrapper called directly; on the
    card also one launch of the kernel for each op call."""
    _, name, build = case
    op_args, wrapper_args = build(torch.Generator().manual_seed(7))
    op_args, wrapper_args = _to(op_args, device), _to(wrapper_args, device)
    op = getattr(torch.ops.qtt, name).default
    torch.library.opcheck(op, op_args)
    before = launch_counts()[name]
    got = op(*op_args)
    if device == "cuda":
        torch.cuda.synchronize()
        assert launch_counts()[name] == before + 1
    assert _equal(got, KERNEL_WRAPPERS[name](*wrapper_args))


def test_every_wrapper_has_its_op():
    assert len(KERNEL_WRAPPERS) == 11 and {c[1] for c in OP_CASES} == set(KERNEL_WRAPPERS)
    for name in KERNEL_WRAPPERS:
        qualified = f"qtt::{name}"
        # the plain version on the CPU, the kernel on CUDA, a fake for tracing
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key), (name, key)


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_op_cpu(case):
    run_case(case, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_op_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the GPU machine)")
    run_case(case, "cuda")
