"""The ``vit`` family: torchvision Vision Transformers (the interface is
``benchmark/families/resnet.py``'s)."""
from __future__ import annotations

import math

from ..core.work import Layer
from ..reference.vit import ViTReference as Reference  # noqa: F401
from ..reference.vit_qat import ViTTrainReference as TrainReference  # noqa: F401


def build_kwargs(arch: dict) -> dict:
    return {"image_size": int(arch["image_size"])}


def weight_specs(arch: dict) -> list:
    """``(key, shape, kind)`` of a torchvision ViT ``state_dict``."""
    e, mlp, p = int(arch["hidden_dim"]), int(arch["mlp_dim"]), int(arch["patch_size"])
    c = int(arch.get("in_channels", 3))
    seq = (int(arch["image_size"]) // p) ** 2 + 1
    specs = [("conv_proj.weight", (e, c, p, p), ("normal", 1.0 / math.sqrt(c * p * p))),
             ("conv_proj.bias", (e,), ("normal", 0.02)),
             ("class_token", (1, 1, e), ("normal", 0.02)),
             ("encoder.pos_embedding", (1, seq, e), ("normal", 0.02))]

    def ln(key):
        specs.extend([(f"{key}.weight", (e,), ("normal1", 0.1)),
                      (f"{key}.bias", (e,), ("normal", 0.02))])

    def linear(key, out, inp):
        specs.extend([(f"{key}.weight", (out, inp), ("normal", 1.0 / math.sqrt(inp))),
                      (f"{key}.bias", (out,), ("normal", 0.02))])

    for i in range(int(arch["num_layers"])):
        t = f"encoder.layers.encoder_layer_{i}"
        ln(f"{t}.ln_1")
        specs.extend([(f"{t}.self_attention.in_proj_weight", (3 * e, e),
                       ("normal", 1.0 / math.sqrt(e))),
                      (f"{t}.self_attention.in_proj_bias", (3 * e,), ("normal", 0.02))])
        linear(f"{t}.self_attention.out_proj", e, e)
        ln(f"{t}.ln_2")
        linear(f"{t}.mlp.0", mlp, e)
        linear(f"{t}.mlp.3", e, mlp)
    ln("encoder.ln")
    linear("heads.head", int(arch["num_classes"]), e)
    return specs


def layers(arch: dict) -> list:
    """The patch conv, every projection, the attention products and the head
    of a torchvision ViT at ``arch["image_size"]`` (S = patches + 1)."""
    e, mlp, p = int(arch["hidden_dim"]), int(arch["mlp_dim"]), int(arch["patch_size"])
    heads, c = int(arch["num_heads"]), int(arch.get("in_channels", 3))
    hw = int(arch["image_size"])
    n = (hw // p) ** 2
    s = n + 1
    out = [Layer("conv_proj", "conv", n * e * p * p * c, hw * hw * c, n * e, p * p * c * e, e)]
    for i in range(int(arch["num_layers"])):
        t = f"encoder_layer_{i}"
        out += [
            Layer(f"{t}.qkv", "linear", s * e * 3 * e, s * e, s * 3 * e, e * 3 * e, 3 * e),
            # QK^T and PV over every head: the scores never leave the kernel
            Layer(f"{t}.attention", "attention", 2 * heads * s * s * (e // heads), 3 * s * e,
                  s * e, 0, 0),
            Layer(f"{t}.out_proj", "linear_wo", s * e * e, s * e, s * e, e * e, e),
            Layer(f"{t}.mlp.0", "linear", s * e * mlp, s * e, s * mlp, e * mlp, mlp),
            Layer(f"{t}.mlp.3", "linear", s * mlp * e, s * mlp, s * e, mlp * e, e),
        ]
    classes = int(arch["num_classes"])
    out.append(Layer("head", "linear", e * classes, e, classes, e * classes, classes))
    return out
