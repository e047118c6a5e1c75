"""Torch WideResNet checkpoints -> the port's variables (a copy of
``quantize_tpu/models/import_wideresnet.py``).

Covers the reference's custom WRN-28/40 checkpoint loading
(``modelzoo/cnns/wideresnet.py:103-118``) and the RobustBench
``rb_wrn-28-10`` entry (``modelzoo/cnns/robustbench.py:13-16``) — both use
the TRADES WideResNet naming: ``conv1``,
``block{1,2,3}.layer.{b}.{bn1,conv1,bn2,conv2,convShortcut}``, top-level
``bn1``, ``fc``.

Pre-activation fold topology: with ``fold_bn`` each block's ``bn2`` (the BN
that follows ``conv1`` in the dataflow) folds into ``conv1``; every ``bn1``
stays a live BatchNorm, and ``conv2`` stays unfolded — matching the model
definition in :mod:`quantize_tpu_torch.models.wideresnet`.
"""
from __future__ import annotations

from typing import Any, Dict

from .import_torch import (StateDict, finish_trees, make_trees, put_bn,
                           put_conv_bn, put_linear)


def import_wideresnet(
    state_dict,
    variables: Dict[str, Any],
    depth: int = 28,
    fold_bn: bool = True,
    into_scale: bool = False,
) -> Dict[str, Any]:
    """Fill ``variables`` (from ``WideResNet.init``) with a TRADES-style
    torch WRN state dict."""
    assert (depth - 4) % 6 == 0
    n = (depth - 4) // 6
    sd = StateDict(state_dict)
    trees = make_trees(variables)

    put_conv_bn(trees, sd, "conv1", None, "conv1", None, fold_bn)
    for stage in range(1, 4):
        for b in range(n):
            ours = f"block{stage}_{b}"
            tp = f"block{stage}.layer.{b}"
            put_bn(trees, sd, f"{ours}/bn1", f"{tp}.bn1")
            put_conv_bn(trees, sd, f"{ours}/conv1", f"{ours}/bn2",
                        f"{tp}.conv1", f"{tp}.bn2", fold_bn, into_scale)
            put_conv_bn(trees, sd, f"{ours}/conv2", None,
                        f"{tp}.conv2", None, fold_bn)
            if f"{tp}.convShortcut.weight" in sd:
                put_conv_bn(trees, sd, f"{ours}/convShortcut", None,
                            f"{tp}.convShortcut", None, fold_bn)
    put_bn(trees, sd, "bn1", "bn1")
    put_linear(trees, sd, "fc", "fc")
    return finish_trees(variables, trees)
