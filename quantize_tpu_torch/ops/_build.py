"""Build and load the port's CUDA kernels (``quantize_tpu_torch/csrc``).

Each ``csrc/<library>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (one entry point per kernel; the
LayerNorm library has two) and loaded with ``ctypes``. The build
happens at first use, into ``quantize_tpu_torch/_build/`` (listed in
``.gitignore``), with one ``nvcc`` process per source, all started
together. A library's file name carries a hash of its sources, so an edited
source is rebuilt and a built one is reused. Nothing here runs at import.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> (library, C function, argtypes)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNELS = {
    "w8a8_gemm": ("w8a8_gemm", "qtt_w8a8_gemm", [_P] * 10 + [_I] * 6 + [_P]),
    "conv1x1_residual": ("conv1x1_residual", "qtt_conv1x1_residual", [_P] * 10 + [_I] * 7 + [_P]),
    "qconv2d": ("qconv2d", "qtt_qconv2d", [_P] * 9 + [_I] * 16 + [_P]),
    "qconv2d_grouped": ("qconv2d_grouped", "qtt_qconv2d_grouped", [_P] * 9 + [_I] * 19 + [_P]),
    "w4a8_gemm": ("w4a8_gemm", "qtt_w4a8_gemm", [_P] * 10 + [_I] * 5 + [_P]),
    "layernorm": ("layernorm", "qtt_layernorm", [_P] * 4 + [_I] * 2 + [_F] + [_I] * 2 + [_P]),
    "layernorm_quant_int8": ("layernorm", "qtt_layernorm_q",
                             [_P] * 6 + [_I] * 2 + [_F] + [_I] * 4 + [_P]),
    "mha_rows": ("mha_rows", "qtt_mha_rows", [_P] * 2 + [_I] * 6 + [_F] + [_I] * 2 + [_P]),
    "wo_gemm": ("wo_gemm", "qtt_wo_gemm", [_P] * 6 + [_I] * 4 + [_P]),
    "mha_rows_int8": ("mha_rows_int8", "qtt_mha_rows_int8",
                      [_P] * 3 + [_I] * 6 + [_F] + [_I] * 3 + [_P]),
    "quantize_act_int8": ("quantize_act", "qtt_quantize_act",
                          [_P] * 4 + [ctypes.c_longlong] + [_I] * 3 + [_P]),
}
LIBRARIES = sorted({lib for lib, _, _ in KERNELS.values()})
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of quantize_tpu_torch "
                       "need the CUDA toolkit (nvcc) to build")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every kernel library (of ``names``, default all) that is not
    built yet, in parallel.

    Returns ``{library: ptxas report}`` for the libraries built by this
    call. Raises RuntimeError with the compiler's output if any build fails.
    """
    names = LIBRARIES if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        reports[name] = log
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failed))
    return reports


def kernel_fn(name: str) -> ctypes._CFuncPtr:
    """The C entry point of kernel ``name``, built on first use."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            build_all()
            libs = {lib: ctypes.CDLL(str(_lib_path(lib))) for lib in LIBRARIES}
            for kname, (lib, sym, argtypes) in KERNELS.items():
                f = getattr(libs[lib], sym)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _fns[kname] = f
    return _fns[name]


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


# -- helpers shared by the kernel wrappers ----------------------------------

def require(t, name: str, device, dtype, shape=None) -> None:
    """Raise ValueError unless ``t`` is a contiguous tensor of ``dtype`` on
    ``device`` (and of ``shape`` when given)."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t):
    """Device pointer of a tensor for ctypes (None -> NULL)."""
    return None if t is None else t.data_ptr()


def current_stream(device) -> int:
    """The calling thread's current stream on ``device`` (a CUDA tensor's
    device) as the raw ``cudaStream_t`` the launchers take, read through
    the C binding: ``torch.cuda.current_stream(device)`` builds a Python
    ``Stream`` object a call, the largest host cost of a launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_SAME_DEVICE = contextlib.nullcontext()


def device_guard(device):
    """``torch.cuda.device(device)`` around a launch on a CUDA tensor's
    ``device`` (the launchers run on the current device), or nothing to
    enter when it is the calling thread's current device already."""
    if device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype) -> int:
    """The launchers' dtype codes: 0 = float32, 1 = bfloat16."""
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {dtype} (float32 or bfloat16)")
    return code
