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
    template). With ``mesh`` (:func:`~quantize_tpu_torch.parallel.mesh.make_mesh`)
    the leaves are placed by
    :func:`~quantize_tpu_torch.parallel.mesh.shard_variables`: on this
    rank's device, each leaf split over ``model`` cut to the rank's slice."""
    restored = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if template is not None:
        from .convert import flatten

        restored = _conform(template, flatten(restored), "")
    if mesh is not None:
        from .parallel.mesh import shard_variables

        restored = shard_variables(mesh, restored)
    return restored
