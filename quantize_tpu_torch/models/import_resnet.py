"""Torchvision ResNet state_dict -> the port's variables (a copy of
``quantize_tpu/models/import_resnet.py``).

Converts a torchvision ``resnet*``/``resnext*``/``wide_resnet*`` checkpoint
(a user-provided ``.pth``) into the flax-named variables tree of
:mod:`quantize_tpu_torch.models.resnet`, performing the reference's BN folding
(``quantconv2d.py:115-133``) when the model was built with
``bn_folding: true`` — including the ``into_scale`` variant that installs
the BN multiplier as the weight-quantizer ``static_scale``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .import_torch import (StateDict, get_node, import_conv_bn,
                           import_linear, set_leaf)


def _bn_to_flax(bn: Dict[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    return {
        "params": {"scale": bn["scale"], "bias": bn["bias"]},
        "batch_stats": {"mean": bn["mean"], "var": bn["var"]},
    }


def import_resnet(
    state_dict,
    variables: Dict[str, Any],
    fold_bn: bool = True,
    into_scale: bool = False,
) -> Dict[str, Any]:
    """Fill ``variables`` (from ``model.init``) with torchvision weights.

    Returns a new variables dict; ``qparams`` static_scales are installed
    when ``into_scale`` (per-layer ``w_quantizer.static_scale``).
    """
    sd = StateDict(state_dict)
    params = _copy(variables["params"])
    batch_stats = _copy(variables.get("batch_stats", {}))
    qparams = _copy(variables.get("qparams", {}))

    def put_conv(our: str, conv_key: str, bn_key: Optional[str]):
        out = import_conv_bn(sd, conv_key, bn_key, fold_bn, into_scale)
        set_leaf(params, f"{our}/kernel", out["kernel"])
        if "bias" in out:
            set_leaf(params, f"{our}/bias", out["bias"])
        if "_static_scale" in out:
            set_leaf(qparams, f"{our}/w_quantizer/static_scale",
                     out["_static_scale"], allow_new=True)
        if "_bn" in out:
            flax_bn = _bn_to_flax(out["_bn"])
            bn_name = {"conv1": "bn1", "conv2": "bn2", "conv3": "bn3",
                       "downsample_conv": "downsample_bn"}.get(our.split("/")[-1])
            parent = "/".join(our.split("/")[:-1])
            bn_path = f"{parent}/{bn_name}" if parent else bn_name
            get_node(params, f"{bn_path}/BatchNorm_0").update(flax_bn["params"])
            get_node(batch_stats, f"{bn_path}/BatchNorm_0").update(flax_bn["batch_stats"])

    put_conv("conv1", "conv1", "bn1")
    for layer_name, layer_tree in sorted(params.items()):
        if not layer_name.startswith("layer") or "_" not in layer_name:
            continue
        stage_blk = layer_name  # e.g. layer1_0
        stage, blk = stage_blk.split("_")
        tprefix = f"{stage}.{blk}"
        for conv_name in ("conv1", "conv2", "conv3"):
            if conv_name in layer_tree:
                put_conv(f"{stage_blk}/{conv_name}", f"{tprefix}.{conv_name}",
                         f"{tprefix}.bn{conv_name[-1]}")
        if "downsample_conv" in layer_tree:
            put_conv(f"{stage_blk}/downsample_conv", f"{tprefix}.downsample.0",
                     f"{tprefix}.downsample.1")

    lin = import_linear(sd, "fc")
    set_leaf(params, "fc/kernel", lin["kernel"])
    if "bias" in lin:
        set_leaf(params, "fc/bias", lin["bias"])

    out_vars = dict(variables)
    out_vars["params"] = params
    if batch_stats:
        out_vars["batch_stats"] = batch_stats
    if qparams:
        out_vars["qparams"] = qparams
    return out_vars


def _copy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree


