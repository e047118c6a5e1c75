"""CIFAR-10/100 (+ corruption variants) from on-disk archives.

Covers the reference datasets ``cifar10``/``cifar100``/``cifar10c``
(``dataset/cifar/cifar10.py:12``, ``cifar10c.py:20``). Reads the standard
python-pickle batch format from ``root``; no download (zero egress). If the
data is absent, raises with a clear message. A copy of
``quantize_tpu/data/cifar.py`` (numpy and pickle only), so both packages
read the same batches.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from .base import DATASETS, ArrayDataset

CIFAR10_CLASSES = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]


def _load_pickle_batches(paths: List[str], label_key: bytes) -> ArrayDataset:
    images, labels = [], []
    for p in paths:
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images.append(np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.extend(d[label_key])
    return ArrayDataset(np.concatenate(images), np.asarray(labels, np.int32))


def _cifar(split_cfg, n_classes: int, transform=None) -> ArrayDataset:
    root = getattr(split_cfg, "root", None) or "."
    split = getattr(split_cfg, "split", None) or "train"
    if n_classes == 10:
        sub = os.path.join(root, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
        paths = [os.path.join(sub, f) for f in files]
        label_key = b"labels"
        classnames = CIFAR10_CLASSES
    else:
        sub = os.path.join(root, "cifar-100-python")
        paths = [os.path.join(sub, "train" if split == "train" else "test")]
        label_key = b"fine_labels"
        classnames = [str(i) for i in range(100)]
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"CIFAR data not found at {p}; place the standard python-format "
                f"archive under {root} (no auto-download in this environment)"
            )
    ds = _load_pickle_batches(paths, label_key)
    ds.classnames = classnames
    ds.transform = transform
    return ds


@DATASETS.register(name="cifar10")
def cifar10(split_cfg, transform=None) -> ArrayDataset:
    return _cifar(split_cfg, 10, transform)


@DATASETS.register(name="cifar100")
def cifar100(split_cfg, transform=None) -> ArrayDataset:
    return _cifar(split_cfg, 100, transform)


@DATASETS.register(name="cifar10c")
def cifar10c(split_cfg, transform=None) -> ArrayDataset:
    """CIFAR-10-C: per-corruption .npy arrays with 5 severity levels
    (reference ``dataset/cifar/cifar10c.py:20``)."""
    root = getattr(split_cfg, "root", None) or "."
    corruption = getattr(split_cfg, "corruption", None) or "gaussian_noise"
    level = int(getattr(split_cfg, "level", None) or 1)
    img_path = os.path.join(root, "CIFAR-10-C", f"{corruption}.npy")
    lab_path = os.path.join(root, "CIFAR-10-C", "labels.npy")
    if not os.path.exists(img_path):
        raise FileNotFoundError(f"CIFAR-10-C data not found at {img_path}")
    images = np.load(img_path)  # (50000, 32, 32, 3), 5 levels x 10000
    labels = np.load(lab_path).astype(np.int32)
    sl = slice((level - 1) * 10000, level * 10000)
    ds = ArrayDataset(images[sl], labels[sl], CIFAR10_CLASSES, transform)
    return ds
