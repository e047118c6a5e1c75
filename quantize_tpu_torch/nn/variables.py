"""Flax-style variable collections on ``torch.nn.Module``s.

The JAX package keeps a model's state in named collections (``params``,
``qparams``, ``qobs``, ``packed``, ``batch_stats``) addressed by slash-joined
module paths (``layer1_0/conv1/w_quantizer/scale``). Here the same state
lives in the modules: ``params`` as ``nn.Parameter`` attributes named by
their leaf (``kernel``, ``bias``), every other collection as buffers named
``<collection>_<leaf>`` (``qparams_scale``, ``qobs_state_xmin``). Each
:class:`VarModule` indexes its entries by ``(collection, leaf)``, so
:func:`collections` can list the whole model under the flax names and
:mod:`quantize_tpu_torch.convert` can load JAX variables buffer by buffer.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch import nn


def _attr(collection: str, leaf: str) -> str:
    flat = leaf.replace("/", "_")
    return flat if collection == "params" else f"{collection}_{flat}"


class VarModule(nn.Module):
    """A module whose state is indexed by flax collection and leaf name."""

    def __init__(self):
        super().__init__()
        self._var_index: Dict[Tuple[str, str], str] = {}

    def put_var(self, collection: str, leaf: str, value: torch.Tensor) -> torch.Tensor:
        """Create or overwrite variable ``leaf`` of ``collection``."""
        attr = _attr(collection, leaf)
        value = value.detach()
        if collection == "params":
            if attr in self._parameters:
                with torch.no_grad():
                    self._parameters[attr].copy_(value)
            else:
                self.register_parameter(attr, nn.Parameter(value.clone()))
        elif attr in self._buffers:
            self._buffers[attr] = value
        else:
            self.register_buffer(attr, value)
        self._var_index[(collection, leaf)] = attr
        return getattr(self, attr)

    def drop_var(self, collection: str, leaf: str) -> None:
        """Remove variable ``leaf`` of ``collection``."""
        attr = self._var_index.pop((collection, leaf))
        if collection == "params":
            del self._parameters[attr]
        else:
            del self._buffers[attr]

    def get_var(self, collection: str, leaf: str) -> torch.Tensor:
        return getattr(self, self._var_index[(collection, leaf)])

    def has_var(self, collection: str, leaf: str) -> bool:
        return (collection, leaf) in self._var_index

    def own_vars(self) -> Iterator[Tuple[str, str, torch.Tensor]]:
        for (col, leaf), attr in self._var_index.items():
            yield col, leaf, getattr(self, attr)


def var_modules(model: nn.Module) -> Iterator[Tuple[str, VarModule]]:
    """``(flax path, module)`` for every :class:`VarModule` in ``model``."""
    for name, mod in model.named_modules():
        if isinstance(mod, VarModule):
            yield name.replace(".", "/"), mod


def collections(model: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{collection: {"path/to/leaf": tensor}}`` over the whole model."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, mod in var_modules(model):
        for col, leaf, t in mod.own_vars():
            key = f"{path}/{leaf}" if path else leaf
            out.setdefault(col, {})[key] = t
    return out
