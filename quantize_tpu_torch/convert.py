"""Carry variables across between the JAX package and the port.

The JAX package's variables are nested dicts ``{collection: {module:
{...: array}}}`` (``params``, ``qparams``, ``qobs``, ``packed``,
``batch_stats``). The port keeps the same state in its modules under the
same flax names (:mod:`quantize_tpu_torch.nn.variables`).
:func:`from_jax_variables` loads such a dict (numpy arrays) into a port
model, creating ``qobs``/``packed`` entries that do not exist yet, and
:func:`to_numpy` gives the model's variables back in the JAX layout, so a
test can compare the two packages buffer by buffer.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .nn.variables import collections, var_modules


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": x}}`` -> ``{"a/b": x}``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def from_jax_variables(model: torch.nn.Module, variables: Mapping[str, Mapping]) -> None:
    """Load the JAX package's variables (numpy-convertible or tensor
    leaves) into ``model`` in place, on the device of the model's tensors.
    Variables sharded over a mesh's ``model`` axis make its layers run
    tensor-parallel (:mod:`~quantize_tpu_torch.parallel.tensor_parallel`)."""
    from .parallel.tensor_parallel import attach

    mods = dict(var_modules(model))
    first = next(itertools.chain(model.parameters(), model.buffers()), None)
    device = first.device if first is not None else torch.device("cpu")
    # sharded variables (parallel.shard_variables over a model axis): the
    # layers that split take their slices, the rest is gathered whole
    variables = attach(model, variables, mods)
    for col, tree in variables.items():
        if col == "taps":
            continue
        for key, value in flatten(tree).items():
            owner, leaf = _owner(mods, key)
            t = (value.detach().clone() if isinstance(value, torch.Tensor)
                 else torch.from_numpy(np.array(value))).to(device)
            if col == "params":
                # a split layer's kernel and bias load at the slice's shape
                want = None
                if owner.has_var(col, leaf):
                    want = (owner.param_shape(leaf) if hasattr(owner, "param_shape") else None
                            ) or tuple(owner.get_var(col, leaf).shape)
                if want is None or want != tuple(t.shape):
                    raise ValueError(f"params/{key}: shape {tuple(t.shape)} does not match "
                                     f"the port's {want}")
            owner.put_var(col, leaf, t)


def _owner(mods: Dict[str, Any], key: str):
    """The deepest module whose path prefixes ``key``, and the leaf name."""
    parts = key.split("/")
    for i in range(len(parts) - 1, -1, -1):  # i == 0: the root module
        path = "/".join(parts[:i])
        if path in mods:
            return mods[path], "/".join(parts[i:])
    raise KeyError(f"no module of the port owns variable {key!r}")


def to_numpy(model: torch.nn.Module) -> Dict[str, Dict[str, Any]]:
    """The model's variables as nested dicts of numpy arrays (JAX layout)."""
    return {col: unflatten({k: v.detach().cpu().float().numpy() if v.dtype == torch.bfloat16
                            else v.detach().cpu().numpy() for k, v in flat.items()})
            for col, flat in collections(model).items()}
