"""OpenAI CLIP state_dict -> the port's variable trees.

A copy of ``quantize_tpu/models/import_clip.py`` (numpy only). Maps an
OpenAI CLIP checkpoint (user-provided; the reference downloads it at
runtime, ``clip/clip.py:30-72``) onto
:class:`quantize_tpu_torch.models.clip.model.CLIP`. Handles both tower
types: the ViT tower (ln_pre/ln_post/proj) and ModifiedResNet (3-conv stem,
bottlenecks, attention pool), plus the causal text transformer. BN folding
for the ResNet tower follows the same transform as :mod:`import_resnet`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .import_torch import StateDict, _np, conv_torch_to_hwio, import_conv_bn, linear_torch_to_io
from .import_vit import _deepcopy, _linear, _ln, _mha


def _resblock(sd: StateDict, t: str, node: Dict[str, Any]) -> None:
    node["ln_1"].update(_ln(sd, f"{t}.ln_1"))
    node["ln_2"].update(_ln(sd, f"{t}.ln_2"))
    mha = _mha(sd, f"{t}.attn")
    for k, v in mha.items():
        node["attn"][k].update(v)
    node["c_fc"].update(_linear(sd, f"{t}.mlp.c_fc"))
    node["c_proj"].update(_linear(sd, f"{t}.mlp.c_proj"))


def _import_vit_tower(sd: StateDict, visual: Dict[str, Any], n_layers: int) -> None:
    visual["conv1"]["kernel"] = conv_torch_to_hwio(sd["visual.conv1.weight"])
    visual["class_embedding"] = _np(sd["visual.class_embedding"])
    visual["positional_embedding"] = _np(sd["visual.positional_embedding"])
    visual["ln_pre"].update(_ln(sd, "visual.ln_pre"))
    visual["ln_post"].update(_ln(sd, "visual.ln_post"))
    visual["proj"] = _np(sd["visual.proj"])
    for i in range(n_layers):
        _resblock(sd, f"visual.transformer.resblocks.{i}", visual["transformer"][f"resblock_{i}"])


def _put_convbn(sd: StateDict, node: Dict[str, Any], stats_node: Dict[str, Any],
                conv_key: str, bn_key: str, fold: bool,
                conv_name: str, bn_name: str) -> None:
    """Import one conv(+BN) site; unfolded BN params/stats land next to it."""
    out = import_conv_bn(sd, conv_key, bn_key, fold)
    node[conv_name]["kernel"] = out["kernel"]
    if "bias" in out:
        node[conv_name]["bias"] = out["bias"]
    if "_bn" in out:
        bn = out["_bn"]
        node[bn_name]["BatchNorm_0"].update({"scale": bn["scale"], "bias": bn["bias"]})
        stats_node.setdefault(bn_name, {})["BatchNorm_0"] = {
            "mean": bn["mean"], "var": bn["var"]}


def _import_rn_tower(sd: StateDict, visual: Dict[str, Any], layers, fold: bool,
                     vstats: Dict[str, Any]) -> None:
    for i in (1, 2, 3):
        _put_convbn(sd, visual, vstats, f"visual.conv{i}", f"visual.bn{i}", fold,
                    f"conv{i}", f"bn{i}")
    for stage, n_blocks in enumerate(layers):
        for b in range(n_blocks):
            key = f"visual.layer{stage + 1}.{b}"
            node = visual[f"layer{stage + 1}_{b}"]
            nstats = vstats.setdefault(f"layer{stage + 1}_{b}", {})
            for ci in (1, 2, 3):
                _put_convbn(sd, node, nstats, f"{key}.conv{ci}", f"{key}.bn{ci}",
                            fold, f"conv{ci}", f"bn{ci}")
            if f"{key}.downsample.0.weight" in sd.sd:
                _put_convbn(sd, node, nstats, f"{key}.downsample.0",
                            f"{key}.downsample.1", fold,
                            "downsample_conv", "downsample_bn")
    ap = visual["attnpool"]
    ap["positional_embedding"] = _np(sd["visual.attnpool.positional_embedding"])
    for p in ("q_proj", "k_proj", "v_proj", "c_proj"):
        ap[p].update(_linear(sd, f"visual.attnpool.{p}"))


def import_clip(state_dict, variables: Dict[str, Any], fold_bn: bool = True) -> Dict[str, Any]:
    """Fill a CLIPZeroShot/CLIP variables tree from an OpenAI checkpoint."""
    sd = StateDict(state_dict)
    out_vars = dict(variables)
    params = _deepcopy(variables["params"])
    bstats = _deepcopy(variables.get("batch_stats", {}))
    clip = params["clip"] if "clip" in params else params

    # text tower
    clip["token_embedding"]["embedding"] = _np(sd["token_embedding.weight"])
    clip["positional_embedding"] = _np(sd["positional_embedding"])
    clip["ln_final"].update(_ln(sd, "ln_final"))
    clip["text_projection"] = _np(sd["text_projection"])
    clip["logit_scale"] = _np(sd["logit_scale"]).reshape(())
    n_text = len([k for k in sd.sd if k.startswith("transformer.resblocks.")
                  and k.endswith(".ln_1.weight")])
    for i in range(n_text):
        _resblock(sd, f"transformer.resblocks.{i}", clip["transformer"][f"resblock_{i}"])

    # vision tower
    if "visual.conv1.weight" in sd.sd and "visual.class_embedding" in sd.sd:
        n_vis = len([k for k in sd.sd if k.startswith("visual.transformer.resblocks.")
                     and k.endswith(".ln_1.weight")])
        _import_vit_tower(sd, clip["visual"], n_vis)
    else:
        # ModifiedResNet: infer stage sizes from keys
        layers = []
        for s in range(1, 5):
            n_b = len([k for k in sd.sd
                       if k.startswith(f"visual.layer{s}.") and k.endswith(".conv1.weight")])
            layers.append(n_b)
        if "clip" in params:
            vstats = bstats.setdefault("clip", {}).setdefault("visual", {})
        else:
            vstats = bstats.setdefault("visual", {})
        _import_rn_tower(sd, clip["visual"], layers, fold_bn, vstats)

    out_vars["params"] = params
    if bstats:
        out_vars["batch_stats"] = bstats
    return out_vars
