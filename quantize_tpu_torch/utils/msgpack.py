"""A msgpack decoder for flax's serialized variables, and a restricted
unpickler for the JAX runner's checkpoint files.

The JAX runner writes a checkpoint as a pickle of ``{"variables": bytes,
"extra": dict}``, the bytes flax's ``serialization.to_bytes`` of the
variables: msgpack with flax's extension types (ndarray, native complex,
numpy scalar) and arrays above 2^30 bytes split into chunks. The port reads
it without depending on the ``msgpack`` package:
:func:`msgpack_restore` is ``flax.serialization.msgpack_restore``'s
counterpart, and :func:`load_jax_checkpoint` unpickles the file with an
:class:`Unpickler` that refuses every global but the numpy scalar and dtype
constructors ``extra`` may hold.
"""
from __future__ import annotations

import io
import pickle
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

# flax.serialization._MsgpackExtType
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# msgpack type bytes: constants, numbers (struct formats), and the
# variable-length kinds with the format of their length
_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
_SIZED = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
          0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
          0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
          0xDC: ("array", "H"), 0xDD: ("array", "I"), 0xDE: ("map", "H"), 0xDF: ("map", "I")}


class _Reader:
    """msgpack's wire format, one object at a time (raw: str as bytes)."""

    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map_(b & 0x0F)
        if b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return self.str_(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.str_(n)
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map_(n)
            return ext_unpack(self.unpack("b"), self.take(n))
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack("b")
            return ext_unpack(code, self.take(1 << (b - 0xD4)))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map_(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """One msgpack object from ``data`` (all of it)."""
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra bytes after the object")
    return out


def _ndarray(data: bytes):
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes);
    bfloat16 (which numpy lacks) comes back as a torch bfloat16 tensor."""
    shape, name, buf = unpackb(data, raw=True)
    if name == b"bfloat16":
        return torch.from_numpy(np.frombuffer(buf, np.int16).copy()).view(
            torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def ext_unpack(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack: unknown extension type {code}")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = tree["chunks"]
            return np.concatenate([chunks[str(i)] for i in range(len(chunks))]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(encoded: bytes) -> Any:
    """flax ``serialization.msgpack_restore``: nested dicts (lists for
    msgpack arrays) with numpy array leaves, chunked arrays joined."""
    return _unchunk(unpackb(encoded))


class Unpickler(pickle.Unpickler):
    """Refuses every global except numpy's scalar and dtype constructors
    (what a numpy scalar in ``extra`` pickles to)."""

    ALLOWED = {("numpy", "dtype"), ("numpy.core.multiarray", "scalar"),
               ("numpy._core.multiarray", "scalar")}

    def find_class(self, module: str, name: str):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(f"global {module}.{name} is not allowed in a "
                                         "checkpoint")
        return super().find_class(module, name)


def load_jax_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(variables, extra)`` of a checkpoint the JAX runner wrote."""
    with open(path, "rb") as f:
        payload = Unpickler(io.BytesIO(f.read())).load()
    if not isinstance(payload, dict) or not isinstance(payload.get("variables"), bytes):
        raise ValueError(f"{path}: not a checkpoint of the JAX runner")
    return msgpack_restore(payload["variables"]), payload.get("extra", {})
