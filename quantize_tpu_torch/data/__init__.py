"""Datasets, loaders and transforms (copies of ``quantize_tpu.data``; no JAX).

Only the synthetic dataset is ported; the CIFAR and ImageNet names raise
NotImplementedError when a config builds them.
"""
from . import synthetic  # noqa: F401  (registry population)
from .base import DATASETS, ArrayDataset, DataLoader, Datum, build_dataloader, build_dataset
from .synthetic import make_synthetic
from .transforms import TRANSFORMS, build_transform
from ..utils.registry import not_ported

DATASETS.register_dict({
    name: not_ported(f"the {name!r} dataset", 7)
    for name in ("cifar10", "cifar100", "cifar10c", "imagenet", "imagenet_a", "imagenet_r",
                 "imagenet_v2", "imagenet_sketch", "imagenet_c")
})

__all__ = [
    "DATASETS", "ArrayDataset", "DataLoader", "Datum",
    "build_dataloader", "build_dataset", "make_synthetic",
    "TRANSFORMS", "build_transform",
]
