"""Dataset core: record type, few-shot sampling, registry.

Functional equivalent of the reference's ``dataset/base.py`` (``Datum``
record ``:22``, few-shot sampling ``:79-121``) and the ``DATASETS`` registry
(``dataset/loader.py:11``), adapted to a numpy-batch world: a dataset yields
``{'img': float32 NHWC, 'label': int32}`` batches. A copy of
``quantize_tpu/data/base.py``, so both packages draw the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils.registry import Registry

DATASETS = Registry("datasets")


@dataclasses.dataclass
class Datum:
    """One example record (reference ``dataset/base.py:22``)."""

    impath: str = ""
    label: int = 0
    domain: str = ""
    classname: str = ""


class ArrayDataset:
    """In-memory dataset over numpy arrays (images NHWC uint8/float32)."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        classnames: Optional[Sequence[str]] = None,
        transform=None,
    ):
        assert len(images) == len(labels)
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        self.classnames = list(classnames) if classnames else [
            str(i) for i in range(int(self.labels.max()) + 1 if len(labels) else 0)
        ]
        self.transform = transform

    @property
    def num_classes(self) -> int:
        return len(self.classnames)

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        imgs = self.images[indices]
        if self.transform is not None:
            imgs = self.transform(imgs)
        imgs = np.asarray(imgs, np.float32)
        return {"img": imgs, "label": self.labels[indices]}

    def few_shot(self, num_shots: int, seed: int = 0) -> "ArrayDataset":
        """Sample ``num_shots`` examples per class (reference
        ``dataset/base.py:79-121``; cache-on-disk keyed by seed is replaced by
        deterministic RNG)."""
        if num_shots is None or num_shots <= 0:
            return self
        rng = np.random.default_rng(seed)
        keep: List[int] = []
        for c in np.unique(self.labels):
            idx = np.flatnonzero(self.labels == c)
            take = min(num_shots, len(idx))
            keep.extend(rng.choice(idx, size=take, replace=False).tolist())
        keep_arr = np.sort(np.asarray(keep))
        return ArrayDataset(self.images[keep_arr], self.labels[keep_arr],
                            self.classnames, self.transform)


class DataLoader:
    """Minimal batching iterator with epoch shuffling.

    Replaces the torch DataLoader usage (``dataset/loader.py:14-37``). Host
    code is plain numpy; device transfer happens in the runner.
    """

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int = 128,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self._epoch = 0
        self._seed = seed
        self.num_workers = int(num_workers)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def __iter__(self):
        if self.num_workers <= 0:
            for idx in self._batch_indices():
                yield self.dataset.get_batch(idx)
            return
        # worker-pipelined batch assembly: keep num_workers get_batch calls
        # in flight (the reference's torch DataLoader num_workers,
        # ``dataset/loader.py:14-37``, as a thread pool — image decode
        # releases the GIL so threads scale for this workload)
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: deque = deque()
            it = self._batch_indices()
            try:
                for _ in range(self.num_workers):
                    pending.append(pool.submit(self.dataset.get_batch, next(it)))
            except StopIteration:
                it = iter(())
            while pending:
                batch = pending.popleft().result()
                try:
                    pending.append(pool.submit(self.dataset.get_batch, next(it)))
                except StopIteration:
                    pass
                yield batch


def build_dataset(cfg: Any, split_cfg: Any, transform=None) -> ArrayDataset:
    """Build a dataset from a ``cfg.train_dataset``-style config node."""
    name = split_cfg.name if hasattr(split_cfg, "name") else split_cfg["name"]
    ctor = DATASETS.lookup(name)
    ds = ctor(split_cfg, transform=transform)
    num_shots = getattr(split_cfg, "num_shots", None)
    if num_shots:
        seed = getattr(cfg, "seed", None) or 0
        ds = ds.few_shot(int(num_shots), seed=seed)
    return ds


def build_dataloader(cfg: Any, which: str, transform=None) -> Optional[DataLoader]:
    """Build loader for 'train'/'val'/'test' using ``cfg.{which}_dataset`` +
    ``cfg.{which}_loader`` (reference ``dataset/loader.py:14``)."""
    split_cfg = getattr(cfg, f"{which}_dataset", None)
    if not split_cfg:
        return None
    loader_cfg = getattr(cfg, f"{which}_loader", None)
    ds = build_dataset(cfg, split_cfg, transform=transform)
    kw = {}
    if loader_cfg:
        kw = {
            "batch_size": getattr(loader_cfg, "batch_size", None) or 128,
            "shuffle": bool(getattr(loader_cfg, "shuffle", False)),
            "drop_last": bool(getattr(loader_cfg, "drop_last", False)),
            "num_workers": int(getattr(loader_cfg, "num_workers", None) or 0),
        }
    return DataLoader(ds, seed=getattr(cfg, "seed", None) or 0, **kw)
