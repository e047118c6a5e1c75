"""Training/eval meters and metrics.

Covers the reference's ``utils/tools.py`` meter + accuracy surface
(``utils/tools.py:18,45,63``). A copy of ``quantize_tpu/utils/meters.py``;
only :func:`set_random_seed` differs: it also seeds torch.
"""
from __future__ import annotations

import random
from typing import Sequence

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed the python, numpy and torch RNGs."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class AverageMeter:
    """Plain running average."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MovingAverageMeter:
    """Exponential moving average with momentum (reference default 0.9 window feel)."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = None

    def update(self, val: float, n: int = 1) -> None:
        del n
        self.val = float(val)
        if self.avg is None:
            self.avg = self.val
        else:
            self.avg = self.momentum * self.avg + (1 - self.momentum) * self.val


def accuracy(output, target, topk: Sequence[int] = (1,)) -> list:
    """Top-k accuracy in percent.

    Args:
        output: logits, shape (N, num_classes) (numpy array or CPU tensor).
        target: labels, shape (N,).
    Returns:
        list of floats, one per k.
    """
    output = np.asarray(output)
    target = np.asarray(target)
    maxk = max(topk)
    # top-maxk indices per row, descending
    pred = np.argsort(-output, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    res = []
    for k in topk:
        res.append(100.0 * correct[:, :k].any(axis=1).mean())
    return res
