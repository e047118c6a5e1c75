"""The one hook on every kernel wrapper: its span, and the contraction it
runs, for the cost recorders of :mod:`quantize_tpu_torch.profiling`.

The hand-written kernels launch through ``ctypes``, where PyTorch's
dispatcher never sees them, so :func:`quantize_tpu_torch.profiling.
layer_costs` could not count them from the ``aten`` calls it watches. Each
contraction kernel's wrapper therefore carries :func:`reports`: while a
recorder is active, a call reports its name, operations, bytes and operand
bits (:func:`contraction_work`, from the call's arguments), and the
``aten`` calls inside it (the plain version a CPU tensor takes) are not
counted again. Without an active recorder the wrapper runs as it is.

Every wrapper of ``ops.KERNEL_WRAPPERS`` carries :func:`reports` under its
name there, the three that run no contraction (KQ, K6, K7) too: each call is
the span ``op.<name>`` (:func:`quantize_tpu_torch.profiling.spanned`).
"""
from __future__ import annotations

import functools
import inspect
from contextlib import contextmanager
from typing import Callable, List, Tuple

import torch

from .. import profiling

# the kernels whose contraction contraction_work counts
CONTRACTIONS = ("w8a8_gemm", "w4a8_gemm", "conv1x1_residual", "qconv2d", "qconv2d_grouped",
                "wo_gemm", "mha_rows", "mha_rows_int8")
# the active recorders: objects with ``kernel(name, ops, nbytes, bits)`` and
# a ``suppressed`` depth that their dispatch mode reads
_ACTIVE: List = []


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def contraction_work(name: str, args: tuple) -> Tuple[int, int, int]:
    """(operations, operand bits, bytes moved once) of one call of kernel
    ``name`` with its wrapper's positional ``args``: each input read once,
    each output written once. The bits choose the peak rate: 8 the int8
    tensor cores, 16 the bf16 ones, 32 the float32 CUDA cores."""
    if name in ("w8a8_gemm", "w4a8_gemm"):
        q, _, _, w, cs, ws, wz, bias = args[:8]
        if w is None:  # given only the K-major copy of the weight: the same bytes
            w = args[9]
        m, k = q.shape
        n = cs.shape[0]
        return 2 * m * n * k, 8, sum(map(_nbytes, (q, w, cs, ws, wz, bias))) + m * n * 4
    if name == "conv1x1_residual":
        # the K-major copy (args[10]) holds the same bytes as w: counted once
        q, _, _, w, cs, ws, bias, res, _, out_dtype = args[:10]
        m, k = q.shape
        n = w.shape[1]
        return (2 * m * n * k, 8,
                sum(map(_nbytes, (q, w, cs, ws, bias, res))) + m * n * _itemsize(out_dtype))
    if name in ("qconv2d", "qconv2d_grouped"):
        # K3g's products run over each group's own channels (w's Ci/G)
        q, _, _, w, ws, wz, bias, _, _, corr, _, out_dtype = args[:12]
        n_img = q.shape[0]
        kh, kw, ci, co = w.shape
        oh, ow = corr.shape[1:3]
        return (2 * n_img * oh * ow * co * kh * kw * ci, 8,
                sum(map(_nbytes, (q, w, ws, wz, bias, corr)))
                + n_img * oh * ow * co * _itemsize(out_dtype))
    if name == "wo_gemm":
        x, w, ws, wz, bias, _ = args
        m, k = x.shape
        n = w.shape[1]
        # bf16 products on the tensor cores, f32 output
        return 2 * m * n * k, 16, sum(map(_nbytes, (x, w, ws, wz, bias))) + m * n * 4
    if name in ("mha_rows", "mha_rows_int8"):
        qkv, heads, s, causal, out_dtype, valid = args
        rows, three_e = qkv.shape
        b, e = rows // s, three_e // 3
        d, v = e // heads, valid or s
        # q.k and ex.v over the valid rows and the keys each attends (all
        # valid keys, or under the causal mask the pairs at or below the
        # diagonal): K9 in int8, K8 in bf16 or float32 (no TF32)
        pairs = v * (v + 1) // 2 if causal else v * v
        bits = 8 if name == "mha_rows_int8" else (16 if qkv.dtype == torch.bfloat16 else 32)
        return (4 * b * heads * pairs * d, bits,
                _nbytes(qkv) + rows * e * _itemsize(out_dtype))
    raise KeyError(f"no contraction cost for kernel {name!r}")


@contextmanager
def suppressed():
    """The ``aten`` contractions inside are the reporting wrapper's own."""
    for rec in _ACTIVE:
        rec.suppressed += 1
    try:
        yield
    finally:
        for rec in _ACTIVE:
            rec.suppressed -= 1


def reports(name: str) -> Callable:
    """Decorator for the wrapper of kernel ``name`` (its ``KERNEL_WRAPPERS``
    name): the span ``op.<name>``, and for a contraction kernel its cost
    while a recorder is active."""
    span = profiling.spanned("op." + name)
    if name not in CONTRACTIONS:
        return span

    def deco(fn: Callable) -> Callable:
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not _ACTIVE:
                return fn(*args, **kw)
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            ops, bits, nbytes = contraction_work(name, bound.args)
            for rec in _ACTIVE:
                if not rec.suppressed:
                    rec.kernel(name, ops, nbytes, bits)
            with suppressed():
                return fn(*args, **kw)

        return span(wrapper)

    return deco
