"""Model-name -> torch-checkpoint importer dispatch.

PyTorch counterpart of ``quantize_tpu/models/import_auto.py``: wires
``cfg.model.torch_checkpoint`` (a user-provided ``.pth`` / ``.pt`` state
dict) to the right converter, the role of the reference's pretrained-weight
loading inside ``build_model`` (``modelzoo/load.py:12``). The converters
work on the variables as nested dicts of numpy arrays under the flax names;
:func:`import_into_model` takes them from a port model and loads the result
back into its modules. The ResNet, MobileNet and WideResNet importers are
ported; the ViT and CLIP importers raise not-ported, naming the ROADMAP.md
queue 1 item that brings them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .. import convert
from ..nn.variables import collections
from ..utils.registry import not_ported_error
from .import_mobilenet import import_mobilenet_v1, import_mobilenet_v2, import_mobilenet_v3
from .import_resnet import import_resnet
from .import_wideresnet import import_wideresnet

_VIT_LAYERS = {"vit_b_16": 12, "vit_b_32": 12, "vit_l_16": 24,
               "vit_l_32": 24, "vit_h_14": 32}

# the collections importers write into (import_torch.make_trees)
_IMPORT_COLLECTIONS = ("params", "batch_stats", "qparams")


def _importer_for(model_name: str) -> Callable[..., Dict[str, Any]]:
    name = model_name.lower()
    if name in _VIT_LAYERS:
        raise not_ported_error(f"the torchvision ViT checkpoint importer ({model_name!r})", 5)
    if name.startswith("clip_"):
        raise not_ported_error(f"the CLIP checkpoint importer ({model_name!r})", 5)
    if name == "mobilenet_v1":
        return import_mobilenet_v1
    if name == "mobilenet_v2":
        return import_mobilenet_v2
    if name.startswith("mobilenet_v3"):
        small = name.endswith("small")
        return lambda sd, v, **kw: import_mobilenet_v3(sd, v, small=small, **kw)
    if name.startswith("wideresnet") or name.startswith("rb_wrn"):
        depth = 28
        if name.startswith("wideresnet"):
            depth = int(name.replace("wideresnet", "") or 28)
        return lambda sd, v, **kw: import_wideresnet(sd, v, depth=depth, **kw)
    if "resnet" in name or "resnext" in name:
        return import_resnet
    raise KeyError(f"no torch-checkpoint importer for model {model_name!r}")


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """Load a .pth/.pt file into a flat state dict of CPU tensors
    (``weights_only``: no pickled code runs; a ``state_dict`` wrapper is
    unwrapped and a ``module.`` prefix stripped)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.removeprefix("module."): v for k, v in obj.items()}


def import_torch_checkpoint(
    model_name: str,
    state_dict: Dict[str, Any],
    variables: Dict[str, Any],
    fold_bn: bool = True,
    into_scale: bool = False,
) -> Dict[str, Any]:
    """Convert ``state_dict`` into ``variables`` (nested numpy dicts) for
    ``model_name``."""
    fn = _importer_for(model_name)
    return fn(state_dict, variables, fold_bn=fold_bn, into_scale=into_scale)


def import_into_model(model: torch.nn.Module, model_name: str, state_dict: Dict[str, Any],
                      fold_bn: bool = True, into_scale: bool = False) -> None:
    """Import ``state_dict`` into ``model`` in place: its ``params``,
    ``batch_stats`` and ``qparams`` go to the importer as numpy trees, and
    what comes back is loaded into the modules on their device. The importer
    creates no node but the weight quantizers' ``static_scale``, so a path the
    model does not have raises KeyError."""
    fn = _importer_for(model_name)
    cols = collections(model)
    variables = {col: convert.unflatten({k: v.detach().cpu().numpy() for k, v in cols[col].items()})
                 for col in _IMPORT_COLLECTIONS if col in cols}
    out = fn(state_dict, variables, fold_bn=fold_bn, into_scale=into_scale)
    convert.from_jax_variables(model, {col: out[col] for col in _IMPORT_COLLECTIONS if col in out})
