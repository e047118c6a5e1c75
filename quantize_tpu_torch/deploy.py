"""Packed-model export: the pack pass and the deploy variables.

PyTorch counterpart of ``quantize_tpu/deploy.py``. :func:`pack_model` runs
the model once in ``mode='pack'``, which writes every layer's integer
weights, baked biases and activation qparams into the ``packed``
collection (buffers of the model's modules), and returns the deploy
variables under their flax names, like the JAX package's deploy pytree:
``packed``, ``params`` without the float kernel and bias of packed layers,
and the other collections except observer state.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .nn.variables import collections

_W_KEYS = ("w_int", "w_p4", "w_p4c")


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, dict):
        x = x["img"]
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32).to(device)


def pack_model(model: torch.nn.Module, sample_x, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Run the pack pass on ``device`` and return the deploy variables
    ``{collection: {"path/leaf": tensor}}``."""
    device = torch.device(device)
    model.to(device)
    with torch.no_grad():
        model(_to_device(sample_x, device), mode="pack")
    cols = collections(model)
    packed = cols.get("packed", {})
    # a packed layer's float kernel and bias go, as in JAX's deploy pytree;
    # a model that is one layer (its variables at the root) keeps them
    packed_layers = {k.rsplit("/", 1)[0] for k in packed
                     if "/" in k and k.rsplit("/", 1)[1] in _W_KEYS}
    params = {k: v for k, v in cols.get("params", {}).items()
              if not ("/" in k and k.rsplit("/", 1)[0] in packed_layers
                      and k.rsplit("/", 1)[1] in ("kernel", "bias"))}
    deploy = {"packed": packed, "params": params}
    for col, val in cols.items():
        if col not in ("params", "packed", "qobs"):
            deploy[col] = val
    return deploy


def model_size_bytes(variables: Dict[str, Any]) -> int:
    """Total bytes of all tensor leaves of a (nested) variables dict."""
    total = 0
    stack = [variables]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += int(node.numel() * node.element_size()) if isinstance(node, torch.Tensor) \
                else int(np.asarray(node).nbytes)
    return total
