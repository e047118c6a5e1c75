"""Checkpoints of a variables dict in the port's own format.

PyTorch counterpart of ``quantize_tpu/checkpoint.py``: :func:`save` writes
the variables (any nesting of dicts with tensor or numpy leaves, the port's
``{collection: {"path/leaf": tensor}}`` or JAX's nested layout) as a
``torch.save`` file of CPU tensors, and :func:`restore` reads it with
``weights_only=True``, so loading runs no pickled code. Quantized state
(scales, zeros, packed integer planes, AdaRound V) is part of the
variables, as in JAX. The JAX package's orbax directories need tensorstore
and are not read here.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .utils.registry import not_ported_error


def _cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return torch.from_numpy(np.array(tree))


def save(path: str, variables: Dict[str, Any], force: bool = True) -> None:
    """Write ``variables`` to ``path`` (a file); without ``force`` an
    existing file raises, as orbax refuses an existing directory."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(_cpu(variables), tmp)
    os.replace(tmp, path)


def _conform(template: Any, restored: Dict[str, torch.Tensor], prefix: str) -> Any:
    if isinstance(template, dict):
        return {k: _conform(v, restored, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if prefix not in restored:
        raise KeyError(f"checkpoint has no leaf {prefix!r} of the template")
    t = template if isinstance(template, torch.Tensor) else torch.from_numpy(np.asarray(template))
    return restored[prefix].to(t.dtype)


def restore(path: str, template: Optional[Dict[str, Any]] = None, mesh=None) -> Dict[str, Any]:
    """Read a checkpoint of :func:`save` (CPU tensors). With ``template``
    the result takes the template's containers and each leaf the dtype of
    the template's leaf at the same path (JAX's ``jax.tree.map`` over the
    template). Restoring onto a mesh is not ported."""
    if mesh is not None:
        raise not_ported_error("restoring a checkpoint onto a mesh (tensor-parallel placement)",
                               6)
    restored = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if template is None:
        return restored
    from .convert import flatten

    return _conform(template, flatten(restored), "")
