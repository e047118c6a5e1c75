"""Engine layer: native host-side dense packing, with the plain version as
fallback.

PyTorch counterpart of ``quantize_tpu/engine/__init__.py``. The native core,
``native/tpack.cpp``, is C++ built with ``g++`` at first use into
``quantize_tpu_torch/_build/`` (its file name carries a hash of the source
and flags, so an edited source is rebuilt) and bound with ``ctypes``. Where
it cannot be built, :func:`get_native` returns None, a warning is logged
once, and :func:`tpack` / :func:`tunpack` run the plain torch version of
:mod:`quantize_tpu_torch.quant.pack`. Both give the same bytes. This is
host work on CPU tensors; nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..quant.pack import PackDescriptor, grid
from ..quant.pack import tpack as _tpack_plain
from ..quant.pack import tunpack as _tunpack_plain

SRC = Path(__file__).resolve().parent / "native" / "tpack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_log = logging.getLogger(__name__)


def lib_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"tpack-{h}.so"


def build() -> Path:
    """Compile ``native/tpack.cpp`` unless it is built; return the library's
    path. Raises ``OSError`` (no ``g++``) or ``CalledProcessError``."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                   capture_output=True, text=True, timeout=120)
    os.replace(tmp, out)
    return out


def get_native() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None where it cannot be
    built or loaded (logged once)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, subprocess.SubprocessError) as exc:
                detail = getattr(exc, "stderr", "") or exc
                _log.warning("the native tpack library did not build (%s); dense packing "
                             "falls back to the plain torch version", detail)
            else:
                p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
                lib.tpack_u32.argtypes = [p, i64, i32, p]
                lib.tunpack_u32.argtypes = [p, i64, i32, p]
                lib.quantize_channel_f32.argtypes = [p, i64, p, p, i64, i64, i32, i32, p]
                for fn in (lib.tpack_u32, lib.tunpack_u32, lib.quantize_channel_f32):
                    fn.restype = None
                _lib = lib
    return _lib


def tpack(x, n_bits: int, signed: bool) -> Tuple[torch.Tensor, PackDescriptor]:
    """Dense-pack integers on the host (a CPU uint8 tensor of
    ``ceil(n * b / 8)`` bytes): native where it is built, else the plain
    version. Values are rounded half to even in float64, then clamped, as
    the JAX package's engine does."""
    t = torch.as_tensor(x).detach().cpu()
    lib = get_native()
    if lib is None:
        return _tpack_plain(t, n_bits, signed)
    lo, hi = grid(n_bits, signed)
    des = PackDescriptor(n_bits, signed, tuple(t.shape))
    v = torch.clamp(torch.round(t.to(torch.float64)), lo, hi).to(torch.int32)
    if signed:
        v += 1 << (n_bits - 1)
    v = v.reshape(-1).contiguous()
    out = torch.zeros(-(-v.numel() * n_bits // 8), dtype=torch.uint8)
    lib.tpack_u32(v.data_ptr(), v.numel(), n_bits, out.data_ptr())
    return out, des


def tunpack(packed, des: PackDescriptor, dtype=torch.float32) -> torch.Tensor:
    """Invert :func:`tpack` on the host (a CPU tensor of ``dtype``)."""
    packed = torch.as_tensor(packed).detach().cpu()
    lib = get_native()
    if lib is None:
        return _tunpack_plain(packed, des, dtype)
    n = 1
    for d in des.shape:
        n *= int(d)
    if packed.dtype != torch.uint8 or packed.numel() < -(-n * des.n_bits // 8):
        raise ValueError(f"tunpack: need {-(-n * des.n_bits // 8)} uint8 bytes for {des}, "
                         f"got {packed.numel()} of {packed.dtype}")
    packed = packed.contiguous()
    vals = torch.empty(n, dtype=torch.int32)
    lib.tunpack_u32(packed.data_ptr(), n, des.n_bits, vals.data_ptr())
    if des.signed:
        vals -= 1 << (des.n_bits - 1)
    return vals.reshape(des.shape).to(dtype)
