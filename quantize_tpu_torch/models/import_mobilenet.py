"""Torch MobileNet checkpoints -> the port's variables (a copy of
``quantize_tpu/models/import_mobilenet.py``).

Covers the reference zoo's MobileNet entries
(``modelzoo/cnns/mobilenet/__init__.py:8-16``): torchvision
``mobilenet_v2`` / ``mobilenet_v3_large`` / ``mobilenet_v3_small`` state
dicts, and the reference's custom MobileNetV1
(``modelzoo/cnns/mobilenet/mobilenetv1.py:44-107``). BN folding (including
``into_scale``) follows the same transform as the ResNet importer
(reference ``quantconv2d.py:115-133``).

BASELINE config[2] ("MobileNetV2 W4 AdaRound on ImageNet") loads through
:func:`import_mobilenet_v2`.
"""
from __future__ import annotations

from typing import Any, Dict

from .import_torch import StateDict, finish_trees, make_trees, put_conv_bn, put_linear
from .mobilenet import _V3_LARGE, _V3_SMALL, MobileNetV2


def import_mobilenet_v2(
    state_dict,
    variables: Dict[str, Any],
    fold_bn: bool = True,
    into_scale: bool = False,
) -> Dict[str, Any]:
    """Fill ``variables`` (from ``MobileNetV2.init``) with torchvision
    ``mobilenet_v2`` weights.

    torchvision block layout: ``features.0`` stem ConvBNActivation;
    ``features.1..17`` InvertedResiduals whose ``conv`` submodule is
    ``[expand ConvBNReLU,] dw ConvBNReLU, project conv, project bn``;
    ``features.18`` head ConvBNActivation; ``classifier.1`` the linear.
    """
    sd = StateDict(state_dict)
    trees = make_trees(variables)

    def put(our_conv, our_bn, conv_key, bn_key):
        put_conv_bn(trees, sd, our_conv, our_bn, conv_key, bn_key,
                    fold_bn, into_scale)

    put("stem_conv", "stem_bn", "features.0.0", "features.0.1")

    feat_idx = 1
    for t, _c, n, _s in MobileNetV2.CFG:
        for _ in range(n):
            ours = f"features_{feat_idx}"
            tk = f"features.{feat_idx}.conv"
            if t != 1:
                put(f"{ours}/expand_conv", f"{ours}/expand_bn",
                    f"{tk}.0.0", f"{tk}.0.1")
                put(f"{ours}/dw_conv", f"{ours}/dw_bn", f"{tk}.1.0", f"{tk}.1.1")
                put(f"{ours}/project_conv", f"{ours}/project_bn",
                    f"{tk}.2", f"{tk}.3")
            else:
                put(f"{ours}/dw_conv", f"{ours}/dw_bn", f"{tk}.0.0", f"{tk}.0.1")
                put(f"{ours}/project_conv", f"{ours}/project_bn",
                    f"{tk}.1", f"{tk}.2")
            feat_idx += 1

    put("head_conv", "head_bn", f"features.{feat_idx}.0", f"features.{feat_idx}.1")
    put_linear(trees, sd, "classifier", "classifier.1")
    return finish_trees(variables, trees)


def import_mobilenet_v3(
    state_dict,
    variables: Dict[str, Any],
    small: bool = False,
    fold_bn: bool = True,
    into_scale: bool = False,
) -> Dict[str, Any]:
    """Fill ``variables`` (from ``MobileNetV3.init``) with torchvision
    ``mobilenet_v3_large``/``_small`` weights (incl. SE blocks)."""
    sd = StateDict(state_dict)
    trees = make_trees(variables)
    cfg = _V3_SMALL if small else _V3_LARGE

    def put(our_conv, our_bn, conv_key, bn_key):
        put_conv_bn(trees, sd, our_conv, our_bn, conv_key, bn_key,
                    fold_bn, into_scale)

    put("stem_conv", "stem_bn", "features.0.0", "features.0.1")

    in_ch = 16
    for i, (_k, exp, out_ch, use_se, _hs, _s) in enumerate(cfg):
        ours = f"features_{i + 1}"
        tk = f"features.{i + 1}.block"
        j = 0
        if exp != in_ch:
            put(f"{ours}/expand_conv", f"{ours}/expand_bn",
                f"{tk}.{j}.0", f"{tk}.{j}.1")
            j += 1
        put(f"{ours}/dw_conv", f"{ours}/dw_bn", f"{tk}.{j}.0", f"{tk}.{j}.1")
        j += 1
        if use_se:
            # torchvision SqueezeExcitation: fc1/fc2 are 1x1 convs with bias
            put(f"{ours}/se/fc1/conv", None, f"{tk}.{j}.fc1", None)
            put(f"{ours}/se/fc2/conv", None, f"{tk}.{j}.fc2", None)
            j += 1
        put(f"{ours}/project_conv", f"{ours}/project_bn",
            f"{tk}.{j}.0", f"{tk}.{j}.1")
        in_ch = out_ch

    head_idx = len(cfg) + 1
    put("head_conv", "head_bn", f"features.{head_idx}.0", f"features.{head_idx}.1")
    put_linear(trees, sd, "pre_classifier", "classifier.0")
    put_linear(trees, sd, "classifier", "classifier.3")
    return finish_trees(variables, trees)


# reference MobileNetV1 layer sizes (mobilenetv1.py:69-73)
_V1_LAYER_SIZES = (1, 2, 2, 6, 2)


def import_mobilenet_v1(
    state_dict,
    variables: Dict[str, Any],
    fold_bn: bool = True,
    into_scale: bool = False,
) -> Dict[str, Any]:
    """Fill ``variables`` (from ``MobileNetV1.init``) with the reference's
    custom-MobileNetV1 state dict (``conv1/bn1`` stem +
    ``layer{1..5}.{b}.{conv1,bn1,conv2,bn2}`` blocks + ``fc``)."""
    sd = StateDict(state_dict)
    trees = make_trees(variables)

    def put(our_conv, our_bn, conv_key, bn_key):
        put_conv_bn(trees, sd, our_conv, our_bn, conv_key, bn_key,
                    fold_bn, into_scale)

    put("stem_conv", "stem_bn", "conv1", "bn1")
    k = 0
    for s, n_blocks in enumerate(_V1_LAYER_SIZES, start=1):
        for b in range(n_blocks):
            tp = f"layer{s}.{b}"
            put(f"dw{k}_conv", f"dw{k}_bn", f"{tp}.conv1", f"{tp}.bn1")
            put(f"pw{k}_conv", f"pw{k}_bn", f"{tp}.conv2", f"{tp}.bn2")
            k += 1
    put_linear(trees, sd, "fc", "fc")
    return finish_trees(variables, trees)
