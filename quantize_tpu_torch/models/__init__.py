"""Model zoo registry (the ResNet family and the ViT family so far).

Constructors take ``(num_classes, ctx, device="cuda")``; ``ctx`` is a
:class:`~quantize_tpu_torch.nn.intercept.QuantCtx` (None builds the FP32
network from the same code).
"""
from __future__ import annotations

from ..utils.registry import Registry
from . import resnet, vit

MODELS = Registry("models")

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
})

__all__ = ["MODELS"]
