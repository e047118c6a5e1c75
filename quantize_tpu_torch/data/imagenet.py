"""ImageNet folder datasets (+ A/R/V2/Sketch/C variants).

Covers the reference's ImageNet family (``dataset/imagenet/imagenet.py:47-84``
and the variant files): a class-per-directory image tree, loaded lazily with
PIL. Like the reference, the folder index and each (seed, shots) few-shot
split are pickle-cached — a second run over a 1.28M-image tree does zero
directory walking. Cache dir: ``QTPU_CACHE_DIR`` (default
``~/.cache/quantize_tpu_torch``; the files carry a ``qtt_`` prefix, so the
port never reads the JAX package's index files, even in a shared
directory); entries invalidate when any class dir's (mtime_ns, size) stat
changes; ``QTPU_INDEX_CACHE=0`` disables. ``QTPU_DECODE_WORKERS`` sizes the
decode pool.

The port of ``quantize_tpu/data/imagenet.py``. Pillow is imported when an
image is decoded, not with the module: ``import quantize_tpu_torch.data``
works without it, and a decode without it
raises ImportError.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from .base import DATASETS

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

_DECODE_POOL: Optional[ThreadPoolExecutor] = None
_DECODE_POOL_WORKERS = 0


def _cache_path(kind: str, key: str) -> Optional[str]:
    if os.environ.get("QTPU_INDEX_CACHE", "1") == "0":
        return None
    d = os.environ.get("QTPU_CACHE_DIR") or os.path.expanduser(
        "~/.cache/quantize_tpu_torch")
    os.makedirs(d, exist_ok=True)
    h = hashlib.sha1(key.encode()).hexdigest()[:16]
    return os.path.join(d, f"qtt_{kind}_{h}.pkl")


def _tree_mtime(root: str, classes: Sequence[str]):
    """Per-class-dir (mtime_ns, size) validity key — one stat per class,
    cheap vs listing 1.28M files. Adding/removing an image updates its
    class dir's nanosecond mtime (so there is no same-second granularity
    window) and usually its directory size; both are compared. Residual
    caveat: a sync tool that preserves directory mtimes exactly AND leaves
    the dirent block count unchanged can still serve a stale index — set
    QTPU_INDEX_CACHE=0 for such trees."""
    def key(p):
        try:
            st = os.stat(p)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return (0, 0)

    return (key(root),) + tuple(key(os.path.join(root, c)) for c in classes)


def _cache_load(path: Optional[str], key):
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if obj.get("mtime") == key:
            return obj["data"]
    except Exception:
        pass
    return None


def _cache_store(path: Optional[str], key, data) -> None:
    if path is None:
        return
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump({"mtime": key, "data": data}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except OSError:
        pass


def _decode_pool() -> Optional[ThreadPoolExecutor]:
    """Shared decode pool (Pillow releases the GIL during JPEG decode, so
    threads scale; the reference used torch DataLoader worker *processes*,
    ``dataset/loader.py:14-37``). QTPU_DECODE_WORKERS=0 disables."""
    global _DECODE_POOL
    workers = int(os.environ.get("QTPU_DECODE_WORKERS", min(32, os.cpu_count() or 8)))
    global _DECODE_POOL_WORKERS
    if workers <= 1:
        return None
    if _DECODE_POOL is None or _DECODE_POOL_WORKERS != workers:
        _DECODE_POOL = ThreadPoolExecutor(max_workers=workers,
                                          thread_name_prefix="qtpu-decode")
        _DECODE_POOL_WORKERS = workers
    return _DECODE_POOL


class FolderDataset:
    """Lazy class-per-directory image dataset (decode on batch access)."""

    def __init__(self, root: str, transform=None, classnames: Optional[Sequence[str]] = None):
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"ImageNet-style directory not found: {root} (no auto-download)"
            )
        self.root = root
        self.transform = transform
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self._tree_mtime = _tree_mtime(root, classes)
        cpath = _cache_path("index", os.path.abspath(root))
        cached = _cache_load(cpath, self._tree_mtime)
        if cached is not None:
            classes, rel_paths, labels = cached
            self.paths = [os.path.join(root, p) for p in rel_paths]
            self.labels_list = list(labels)
        else:
            self.paths = []
            self.labels_list = []
            for ci, cls in enumerate(classes):
                cdir = os.path.join(root, cls)
                for fname in sorted(os.listdir(cdir)):
                    if fname.lower().endswith(_IMG_EXTS):
                        self.paths.append(os.path.join(cdir, fname))
                        self.labels_list.append(ci)
            rel = [os.path.relpath(p, root) for p in self.paths]
            _cache_store(cpath, self._tree_mtime,
                         (classes, rel, self.labels_list))
        self.classnames = list(classnames) if classnames else classes
        self.labels = np.asarray(self.labels_list, np.int32)

    @property
    def num_classes(self) -> int:
        return len(self.classnames)

    def __len__(self) -> int:
        return len(self.paths)

    def _decode(self, i: int) -> np.ndarray:
        try:
            from PIL import Image
        except ImportError as exc:
            raise ImportError("decoding an image of a folder dataset needs Pillow (PIL), "
                              "which is not installed") from exc
        with Image.open(self.paths[int(i)]) as im:
            return np.asarray(im.convert("RGB"))

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        pool = _decode_pool()
        if pool is not None and len(indices) > 1:
            imgs = list(pool.map(self._decode, indices))
        else:
            imgs = [self._decode(i) for i in indices]

        def _tf(chunk):
            # transforms handle ragged sizes via per-image PIL ops
            return self.transform(
                np.asarray(chunk, dtype=object) if _ragged(chunk)
                else np.stack(chunk))

        if self.transform is not None:
            if pool is not None and len(imgs) > 1:
                # transforms (PIL resize/crop release the GIL too) run on
                # per-worker chunks in the same pool — a serial batch
                # transform was measured NOT to scale with decode workers
                # (scripts/bench_decode.py), capping the feed rate
                nw = pool._max_workers
                size = max(1, -(-len(imgs) // nw))
                chunks = [imgs[k:k + size] for k in range(0, len(imgs), size)]
                parts = list(pool.map(_tf, chunks))
                batch = np.concatenate([np.asarray(p) for p in parts])
            else:
                batch = _tf(imgs)
        else:
            batch = np.stack(imgs)
        return {"img": np.asarray(batch, np.float32), "label": self.labels[indices]}

    def few_shot(self, num_shots: int, seed: int = 0) -> "FolderDataset":
        if not num_shots or num_shots <= 0:
            return self
        # per-class-count signature in the key: distinct views (subclass
        # splits, prior few-shots) of the same root must never collide for
        # the same (seed, shots), even at equal length/class-count
        sig = hashlib.sha1(np.bincount(
            self.labels, minlength=self.num_classes).tobytes()).hexdigest()[:12]
        cpath = _cache_path(
            "fewshot",
            f"{os.path.abspath(self.root)}|n={len(self)}"
            f"|sig={sig}|seed={seed}|shots={num_shots}")
        keep_sorted = _cache_load(cpath, getattr(self, "_tree_mtime", 0.0))
        if keep_sorted is None:
            rng = np.random.default_rng(seed)
            keep: List[int] = []
            for c in np.unique(self.labels):
                idx = np.flatnonzero(self.labels == c)
                keep.extend(rng.choice(idx, size=min(num_shots, len(idx)),
                                       replace=False).tolist())
            keep_sorted = sorted(keep)
            _cache_store(cpath, getattr(self, "_tree_mtime", 0.0), keep_sorted)
        out = object.__new__(FolderDataset)
        out.root, out.transform, out.classnames = self.root, self.transform, self.classnames
        out._tree_mtime = getattr(self, "_tree_mtime", 0.0)
        out.paths = [self.paths[i] for i in keep_sorted]
        out.labels_list = [self.labels_list[i] for i in keep_sorted]
        out.labels = np.asarray(out.labels_list, np.int32)
        return out


    def select_subclass(self, subclass: str = "all") -> "FolderDataset":
        """Base/new class split for base-to-new generalization (reference
        ``imagenet.py:140-181``): ``base`` keeps the first ceil(C/2) classes,
        ``new`` the rest; labels are re-indexed to 0..m-1 and classnames
        restricted accordingly."""
        assert subclass in ("all", "base", "new"), subclass
        if subclass == "all":
            return self
        import math

        labels = sorted(np.unique(self.labels).tolist())
        m = math.ceil(len(labels) / 2)
        selected = labels[:m] if subclass == "base" else labels[m:]
        relabel = {lab: i for i, lab in enumerate(selected)}
        keep = [i for i, lab in enumerate(self.labels_list) if lab in relabel]
        out = object.__new__(FolderDataset)
        out.root, out.transform = self.root, self.transform
        out._tree_mtime = getattr(self, "_tree_mtime", 0.0)
        out.classnames = [self.classnames[lab] for lab in selected]
        out.paths = [self.paths[i] for i in keep]
        out.labels_list = [relabel[self.labels_list[i]] for i in keep]
        out.labels = np.asarray(out.labels_list, np.int32)
        return out


def _ragged(imgs: List[np.ndarray]) -> bool:
    return len({im.shape for im in imgs}) > 1


def _folder(split_cfg, transform, subdir_attr: str = "split") -> FolderDataset:
    root = getattr(split_cfg, "root", None) or "."
    split = getattr(split_cfg, subdir_attr, None) or "val"
    ds = FolderDataset(os.path.join(root, split), transform=transform)
    subclass = getattr(split_cfg, "subclass", None)
    if subclass:
        ds = ds.select_subclass(str(subclass))
    return ds


@DATASETS.register(name="imagenet")
def imagenet(split_cfg, transform=None) -> FolderDataset:
    return _folder(split_cfg, transform)


@DATASETS.register(name="imagenet_a")
def imagenet_a(split_cfg, transform=None) -> FolderDataset:
    return _folder(split_cfg, transform)


@DATASETS.register(name="imagenet_r")
def imagenet_r(split_cfg, transform=None) -> FolderDataset:
    return _folder(split_cfg, transform)


@DATASETS.register(name="imagenet_v2")
def imagenet_v2(split_cfg, transform=None) -> FolderDataset:
    return _folder(split_cfg, transform)


@DATASETS.register(name="imagenet_sketch")
def imagenet_sketch(split_cfg, transform=None) -> FolderDataset:
    return _folder(split_cfg, transform)


@DATASETS.register(name="imagenet_c")
def imagenet_c(split_cfg, transform=None) -> FolderDataset:
    """ImageNet-C: root/<corruption>/<level>/<class>/*.jpg
    (reference ``dataset/imagenet/imagenet_c.py:18-66``)."""
    root = getattr(split_cfg, "root", None) or "."
    corruption = getattr(split_cfg, "corruption", None) or "gaussian_noise"
    level = str(getattr(split_cfg, "level", None) or 1)
    return FolderDataset(os.path.join(root, corruption, level), transform=transform)
