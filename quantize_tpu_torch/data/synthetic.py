"""Synthetic classification dataset for tests and benchmarks.

No reference counterpart (the reference always needs ImageNet/CIFAR on
disk); with zero network egress this framework ships a deterministic
separable image dataset so every pipeline is runnable out of the box.
A copy of ``quantize_tpu/data/synthetic.py``.
"""
from __future__ import annotations

import numpy as np

from .base import DATASETS, ArrayDataset


def make_synthetic(
    n: int = 512,
    image_size: int = 32,
    channels: int = 3,
    num_classes: int = 10,
    noise: float = 0.3,
    seed: int = 0,
    proto_seed: int = 42,
) -> ArrayDataset:
    """Gaussian class prototypes + noise: linearly separable images whose
    class signal survives quantization, so accuracy deltas are meaningful.

    ``proto_seed`` fixes the class prototypes (the *task*); ``seed`` only
    varies which examples are drawn — so train/val/test share one task.
    """
    proto_rng = np.random.default_rng(proto_seed)
    protos = proto_rng.normal(size=(num_classes, image_size, image_size, channels)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    images = protos[labels] + noise * rng.normal(size=(n, image_size, image_size, channels)).astype(np.float32)
    return ArrayDataset(images.astype(np.float32), labels,
                        classnames=[f"class_{i}" for i in range(num_classes)])


@DATASETS.register(name="synthetic")
def synthetic(split_cfg, transform=None) -> ArrayDataset:
    get = lambda k, d: (getattr(split_cfg, k, None) if hasattr(split_cfg, k) else None) or d  # noqa: E731
    split = get("split", "train")
    seed_offset = {"train": 0, "val": 1, "test": 2}.get(split, 0)
    ds = make_synthetic(
        n=get("n", 512),
        image_size=get("image_size", 32),
        num_classes=get("num_classes", 10),
        noise=get("noise", 0.3),
        seed=get("data_seed", 1234) + seed_offset,
    )
    ds.transform = transform
    return ds
