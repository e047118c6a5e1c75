"""Model zoo registry (the ResNet, MobileNet, WideResNet, ViT and CLIP
families and the test CNNs) and :func:`build_model`.

Constructors take ``(num_classes, ctx, device="cuda")``; ``ctx`` is a
:class:`~quantize_tpu_torch.nn.intercept.QuantCtx` (None builds the FP32
network from the same code).

Every model the registry builds carries the program's spans
(:func:`~quantize_tpu_torch.profiling.span_module`): its forward is
``forward.<mode>`` and each residual or encoder block ``block.<path>``,
ranges that exist only while PyTorch's profiler is on.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import profiling
from ..nn.intercept import QuantCtx
from ..utils.config import Config
from ..utils.registry import Registry
from . import mobilenet, resnet, vit, wideresnet
from .clip import CLIP_MODELS
from .clip.model import CLIPBottleneck, ResidualAttentionBlock
from .testnet import TestCNN, TrajNet

# the residual and encoder blocks, each spanned as block.<its path>
BLOCKS = (resnet.BasicBlock, resnet.Bottleneck, wideresnet.WRNBasicBlock,
          mobilenet.InvertedResidual, mobilenet.MNV3Block, vit.EncoderBlock, CLIPBottleneck,
          ResidualAttentionBlock)


def span_model(model: torch.nn.Module) -> torch.nn.Module:
    """Span ``model``'s forward as ``forward.<mode>`` and each of its
    :data:`BLOCKS` as ``block.<path>``; returns ``model``."""
    for path, mod in model.named_modules():
        if isinstance(mod, BLOCKS):
            profiling.span_module(mod, "block." + path)
    return profiling.span_module(model)


class _ModelRegistry(Registry):
    def build(self, name: str, *args, **kwargs):
        return span_model(super().build(name, *args, **kwargs))


MODELS = _ModelRegistry("models")

MODELS.register_dict({
    "resnet18": resnet.resnet18,
    "resnet34": resnet.resnet34,
    "resnet50": resnet.resnet50,
    "resnet101": resnet.resnet101,
    "resnet152": resnet.resnet152,
    "resnext50_32x4d": resnet.resnext50_32x4d,
    "resnext101_32x8d": resnet.resnext101_32x8d,
    "resnext101_64x4d": resnet.resnext101_64x4d,
    "wide_resnet50_2": resnet.wide_resnet50_2,
    "wide_resnet101_2": resnet.wide_resnet101_2,
    "vit_b_16": vit.vit_b_16,
    "vit_b_32": vit.vit_b_32,
    "vit_l_16": vit.vit_l_16,
    "vit_l_32": vit.vit_l_32,
    "vit_h_14": vit.vit_h_14,
    "wideresnet28": wideresnet.wideresnet28,
    "wideresnet40": wideresnet.wideresnet40,
    "rb_wrn-28-10": wideresnet.rb_wrn_28_10,
    "mobilenet_v1": mobilenet.mobilenet_v1,
    "mobilenet_v2": mobilenet.mobilenet_v2,
    "mobilenet_v3_large": mobilenet.mobilenet_v3_large,
    "mobilenet_v3_small": mobilenet.mobilenet_v3_small,
    "testcnn": TestCNN,
    "trajnet": TrajNet,
})
MODELS.register_dict(CLIP_MODELS)

_RESERVED_MODEL_KEYS = {
    "name", "num_classes", "classnames", "prompts", "checkpoint", "pretrained",
    "torch_checkpoint", "torch_checkpoint_sha256",
}


def build_model(cfg_model: Config, ctx: Optional[QuantCtx] = None, device="cuda"):
    """Build a model on ``device`` from ``cfg.model``: ``name`` +
    ``num_classes`` plus any extra keys passed through to the constructor
    (e.g. ``width``), as ``quantize_tpu.models.build_model`` does."""
    if cfg_model is None:
        raise ValueError("cfg.model is missing — set model.name in the config "
                         "(e.g. --opts model.name=resnet18)")
    if isinstance(cfg_model, Config):
        d = cfg_model.to_dict()
    else:
        d = dict(cfg_model)
    if not d.get("name"):
        raise ValueError("cfg.model.name is missing — set model.name in the config")
    name = d["name"]
    num_classes = d.get("num_classes") or 1000
    kwargs = {k: v for k, v in d.items() if k not in _RESERVED_MODEL_KEYS}
    return MODELS.build(name, num_classes=num_classes, ctx=ctx, device=device, **kwargs)


__all__ = ["BLOCKS", "MODELS", "build_model", "span_model"]
