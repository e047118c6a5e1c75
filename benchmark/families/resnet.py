"""The ``resnet`` family: torchvision ResNet and ResNeXt.

What the harness needs of a model family, in the file named after it
(``benchmark/families/<family>.py``, found by a configuration's
``family``): ``weight_specs(arch)``, the seeded weights' keys, shapes and
draws; ``layers(arch)``, its contractions for the work arithmetic;
``build_kwargs(arch)``, what the port's model registry takes beyond the
class count; ``Reference``, the plain inference reference; and
``TrainReference``, the plain training reference, or None where the family
has none.
"""
from __future__ import annotations

import math

from ..core.work import Layer
from ..reference.resnet import ResNetReference as Reference  # noqa: F401

TrainReference = None


def build_kwargs(arch: dict) -> dict:
    return {}


def weight_specs(arch: dict) -> list:
    """``(key, shape, kind)`` of a torchvision ResNet/ResNeXt ``state_dict``."""
    specs = []

    def conv(key, co, ci, k):
        specs.append((f"{key}.weight", (co, ci, k, k), ("normal", math.sqrt(2.0 / (ci * k * k)))))

    def bn(key, c):
        specs.extend([(f"{key}.weight", (c,), ("normal1", 0.1)),
                      (f"{key}.bias", (c,), ("normal", 0.1)),
                      (f"{key}.running_mean", (c,), ("normal", 0.1)),
                      (f"{key}.running_var", (c,), ("uniform", 0.5)),
                      (f"{key}.num_batches_tracked", (), ("count", 1000))])

    groups, wpg = int(arch.get("groups", 1)), int(arch.get("width_per_group", 64))
    stem = int(arch.get("stem_width", 64))
    conv("conv1", stem, int(arch.get("in_channels", 3)), 7)
    bn("bn1", stem)
    in_ch, expansion = stem, 4 if arch["bottleneck"] else 1
    for stage, n_blocks in enumerate(arch["stage_sizes"]):
        planes = 64 * 2 ** stage
        width = planes * wpg // 64 * groups
        out_ch = planes * expansion
        for b in range(n_blocks):
            p = f"layer{stage + 1}.{b}"
            if arch["bottleneck"]:
                convs = [(width, in_ch, 1), (width, width // groups, 3), (out_ch, width, 1)]
            else:
                convs = [(planes, in_ch, 3), (planes, planes, 3)]
            for i, (co, ci, k) in enumerate(convs, 1):
                conv(f"{p}.conv{i}", co, ci, k)
                bn(f"{p}.bn{i}", co)
            stride = 2 if stage > 0 and b == 0 else 1
            if b == 0 and (stride != 1 or in_ch != out_ch):
                conv(f"{p}.downsample.0", out_ch, in_ch, 1)
                bn(f"{p}.downsample.1", out_ch)
            in_ch = out_ch
    classes = int(arch["num_classes"])
    specs.append(("fc.weight", (classes, in_ch), ("normal", 1.0 / math.sqrt(in_ch))))
    specs.append(("fc.bias", (classes,), ("normal", 0.02)))
    return specs


def layers(arch: dict) -> list:
    """Every conv and the head of a torchvision ResNet/ResNeXt at
    ``arch["image_size"]``; a bottleneck's last 1x1 conv, which the fused
    tail adds the residual to, is ``conv_residual``."""
    hw = int(arch["image_size"])
    groups, wpg = int(arch.get("groups", 1)), int(arch.get("width_per_group", 64))
    stem, cin = int(arch.get("stem_width", 64)), int(arch.get("in_channels", 3))
    out = []

    def conv(name, h, ci, co, k, s, g=1, kind="conv", residual=False):
        ho = (h + 2 * (k // 2) - k) // s + 1
        out.append(Layer(name, kind, ho * ho * co * k * k * ci // g, h * h * ci, ho * ho * co,
                         k * k * ci // g * co, co, ho * ho * co if residual else 0))
        return ho

    h = conv("conv1", hw, cin, stem, 7, 2)
    h = (h + 2 - 3) // 2 + 1  # max pool 3x3, stride 2, padding 1
    in_ch, expansion = stem, 4 if arch["bottleneck"] else 1
    for stage, n_blocks in enumerate(arch["stage_sizes"]):
        planes = 64 * 2 ** stage
        width = planes * wpg // 64 * groups
        out_ch = planes * expansion
        for b in range(n_blocks):
            p, s = f"layer{stage + 1}.{b}", 2 if stage > 0 and b == 0 else 1
            if arch["bottleneck"]:
                conv(f"{p}.conv1", h, in_ch, width, 1, 1)
                ho = conv(f"{p}.conv2", h, width, width, 3, s, groups)
                conv(f"{p}.conv3", ho, width, out_ch, 1, 1, kind="conv_residual", residual=True)
            else:
                ho = conv(f"{p}.conv1", h, in_ch, planes, 3, s)
                conv(f"{p}.conv2", ho, planes, planes, 3, 1)
            if b == 0 and (s != 1 or in_ch != out_ch):
                conv(f"{p}.downsample.0", h, in_ch, out_ch, 1, s)
            h, in_ch = ho, out_ch
    classes = int(arch["num_classes"])
    out.append(Layer("fc", "linear", in_ch * classes, in_ch, classes, in_ch * classes, classes))
    return out
