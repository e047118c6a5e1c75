"""Datasets, loaders and transforms (copies of ``quantize_tpu.data``; no JAX).

The synthetic, CIFAR (``cifar10``, ``cifar100``, ``cifar10c``) and ImageNet
folder (``imagenet`` and its ``_a``, ``_r``, ``_v2``, ``_sketch`` and ``_c``
variants) datasets register their names here. Pillow is needed only to
decode folder images and by the PIL-based transforms, when they run.
"""
from . import cifar, imagenet, synthetic  # noqa: F401  (registry population)
from .base import DATASETS, ArrayDataset, DataLoader, Datum, build_dataloader, build_dataset
from .imagenet import FolderDataset
from .synthetic import make_synthetic
from .transforms import TRANSFORMS, build_transform

__all__ = [
    "DATASETS", "ArrayDataset", "DataLoader", "Datum", "FolderDataset",
    "build_dataloader", "build_dataset", "make_synthetic",
    "TRANSFORMS", "build_transform",
]
