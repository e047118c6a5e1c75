"""Quantization-aware MobileNet family (NHWC).

PyTorch counterpart of ``quantize_tpu/models/mobilenet.py``: mobilenet_v1
(the reference's custom V1), mobilenet_v2 (with ``width_mult``) and
mobilenet_v3_small/large. Depthwise convs are ``feature_group_count ==
channels`` and quantize per out-channel like any other conv; packed, they
take the float path of :class:`~quantize_tpu_torch.nn.layers.QuantConv`.
Module names follow the flax tree (``features_3/expand_conv``,
``features_5/se/fc1/conv``), so variables load one to one from the JAX
package. The int8 carry between blocks (JAX's ``packed_qin_carry``) is not
ported, so the blocks always carry floats.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.intercept import QuantCtx
from ..nn.layers import QuantConv, QuantDense
from .resnet import ResNet, _Stage


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    # a true division, as eager JAX's: on CUDA PyTorch turns a division by
    # a Python scalar into a multiplication by its float32 reciprocal
    six = torch.tensor(6.0, dtype=torch.float32, device=x.device)
    return relu6(x + 3.0) / six


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _Net(_Stage):
    """Shared by the MobileNets: kernels drawn in module order, as ResNet's."""

    init_params = ResNet.init_params


class MobileNetV1(_Net):
    """Reference custom MobileNetV1 (``mobilenetv1.py:44-107``)."""

    # (out_channels, stride) for the 13 depthwise-separable blocks
    CFG: Sequence[Tuple[int, int]] = (
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
    )

    def __init__(self, num_classes: int = 1000, ctx: Optional[QuantCtx] = None,
                 in_channels: int = 3, device="cuda"):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        device = torch.device(device)
        self._add_conv_bn(ctx, "/model/0/0", in_channels, 32, (3, 3), (2, 2),
                          name_conv="stem_conv", name_bn="stem_bn", device=device)
        in_ch = 32
        for i, (out_ch, stride) in enumerate(self.CFG):
            base = f"/model/{i + 1}"
            self._add_conv_bn(ctx, f"{base}/0", in_ch, in_ch, (3, 3), (stride, stride),
                              groups=in_ch, name_conv=f"dw{i}_conv", name_bn=f"dw{i}_bn",
                              device=device)
            self._add_conv_bn(ctx, f"{base}/3", in_ch, out_ch, (1, 1),
                              name_conv=f"pw{i}_conv", name_bn=f"pw{i}_bn", device=device)
            in_ch = out_ch
        self.fc = QuantDense(in_ch, num_classes, quant=ctx.resolve("/fc", "nn_linear"),
                             device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        x = torch.relu(self._conv_bn("stem_conv", "stem_bn", x, mode))
        for i in range(len(self.CFG)):
            x = torch.relu(self._conv_bn(f"dw{i}_conv", f"dw{i}_bn", x, mode))
            x = torch.relu(self._conv_bn(f"pw{i}_conv", f"pw{i}_bn", x, mode))
        return self.fc(x.mean(dim=(1, 2)), mode=mode)


class InvertedResidual(_Stage):
    def __init__(self, ctx: QuantCtx, qpath: str, in_ch: int, out_ch: int, stride: int,
                 expand_ratio: int, device=None):
        super().__init__()
        hidden = int(round(in_ch * expand_ratio))
        self.use_res = stride == 1 and in_ch == out_ch
        self.expand = expand_ratio != 1
        idx = 0
        if self.expand:
            self._add_conv_bn(ctx, f"{qpath}/conv/{idx}/0", in_ch, hidden, (1, 1),
                              name_conv="expand_conv", name_bn="expand_bn", device=device)
            idx += 1
        self._add_conv_bn(ctx, f"{qpath}/conv/{idx}/0", hidden, hidden, (3, 3), (stride, stride),
                          groups=hidden, name_conv="dw_conv", name_bn="dw_bn", device=device)
        self._add_conv_bn(ctx, f"{qpath}/conv/{idx + 1}", hidden, out_ch, (1, 1),
                          name_conv="project_conv", name_bn="project_bn", device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        out = x
        if self.expand:
            out = relu6(self._conv_bn("expand_conv", "expand_bn", out, mode))
        out = relu6(self._conv_bn("dw_conv", "dw_bn", out, mode))
        out = self._conv_bn("project_conv", "project_bn", out, mode)
        return x + out if self.use_res else out


class MobileNetV2(_Net):
    # t (expand), c (channels), n (repeats), s (stride)
    CFG: Sequence[Tuple[int, int, int, int]] = (
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    )

    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 ctx: Optional[QuantCtx] = None, in_channels: int = 3, device="cuda"):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        device = torch.device(device)
        in_ch = _make_divisible(32 * width_mult)
        self._add_conv_bn(ctx, "/features/0/0", in_channels, in_ch, (3, 3), (2, 2),
                          name_conv="stem_conv", name_bn="stem_bn", device=device)
        self.block_names = []
        feat_idx = 1
        for t, c, n, s in self.CFG:
            out_ch = _make_divisible(c * width_mult)
            for i in range(n):
                name = f"features_{feat_idx}"
                setattr(self, name, InvertedResidual(ctx, f"/features/{feat_idx}", in_ch, out_ch,
                                                     s if i == 0 else 1, t, device))
                self.block_names.append(name)
                in_ch = out_ch
                feat_idx += 1
        last_ch = _make_divisible(1280 * max(1.0, width_mult))
        self._add_conv_bn(ctx, f"/features/{feat_idx}/0", in_ch, last_ch, (1, 1),
                          name_conv="head_conv", name_bn="head_bn", device=device)
        self.classifier = QuantDense(last_ch, num_classes,
                                     quant=ctx.resolve("/classifier/1", "nn_linear"),
                                     device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        x = relu6(self._conv_bn("stem_conv", "stem_bn", x, mode))
        for name in self.block_names:
            x = getattr(self, name)(x, mode)
        x = relu6(self._conv_bn("head_conv", "head_bn", x, mode))
        return self.classifier(x.mean(dim=(1, 2)), mode=mode)


class _SEConv(nn.Module):
    """1x1 conv with bias (no BN) used inside SE blocks."""

    def __init__(self, ctx: QuantCtx, qpath: str, in_ch: int, features: int, device=None):
        super().__init__()
        self.conv = QuantConv(in_ch, features, (1, 1), use_bias=True,
                              quant=ctx.resolve(qpath, "nn_conv2d"), device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        return self.conv(x, mode=mode)


class SqueezeExcite(nn.Module):
    def __init__(self, ctx: QuantCtx, qpath: str, channels: int, squeeze: int, device=None):
        super().__init__()
        self.fc1 = _SEConv(ctx, f"{qpath}/fc1", channels, squeeze, device)
        self.fc2 = _SEConv(ctx, f"{qpath}/fc2", squeeze, channels, device)

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = torch.relu(self.fc1(s, mode))
        s = self.fc2(s, mode)
        return x * hard_sigmoid(s)


class MNV3Block(_Stage):
    def __init__(self, ctx: QuantCtx, qpath: str, in_ch: int, exp_ch: int, out_ch: int,
                 kernel: int, stride: int, use_se: bool, use_hs: bool, device=None):
        super().__init__()
        self.act = hard_swish if use_hs else torch.relu
        self.use_res = stride == 1 and in_ch == out_ch
        self.expand = exp_ch != in_ch
        idx = 0
        if self.expand:
            self._add_conv_bn(ctx, f"{qpath}/block/{idx}/0", in_ch, exp_ch, (1, 1),
                              name_conv="expand_conv", name_bn="expand_bn", device=device)
            idx += 1
        self._add_conv_bn(ctx, f"{qpath}/block/{idx}/0", exp_ch, exp_ch, (kernel, kernel),
                          (stride, stride), groups=exp_ch, name_conv="dw_conv", name_bn="dw_bn",
                          device=device)
        idx += 1
        if use_se:
            self.se = SqueezeExcite(ctx, f"{qpath}/block/{idx}", exp_ch,
                                    _make_divisible(exp_ch // 4), device)
            idx += 1
        self._add_conv_bn(ctx, f"{qpath}/block/{idx}/0", exp_ch, out_ch, (1, 1),
                          name_conv="project_conv", name_bn="project_bn", device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        out = x
        if self.expand:
            out = self.act(self._conv_bn("expand_conv", "expand_bn", out, mode))
        out = self.act(self._conv_bn("dw_conv", "dw_bn", out, mode))
        if hasattr(self, "se"):
            out = self.se(out, mode)
        out = self._conv_bn("project_conv", "project_bn", out, mode)
        return x + out if self.use_res else out


_V3_LARGE = [
    # k, exp, out, se, hs, s
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]

_V3_SMALL = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]


class MobileNetV3(_Net):
    def __init__(self, num_classes: int = 1000, small: bool = False,
                 ctx: Optional[QuantCtx] = None, in_channels: int = 3, device="cuda"):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        device = torch.device(device)
        cfg = _V3_SMALL if small else _V3_LARGE
        self._add_conv_bn(ctx, "/features/0/0", in_channels, 16, (3, 3), (2, 2),
                          name_conv="stem_conv", name_bn="stem_bn", device=device)
        in_ch = 16
        self.block_names = []
        for i, (k, exp, out_ch, se, hs, s) in enumerate(cfg):
            name = f"features_{i + 1}"
            setattr(self, name, MNV3Block(ctx, f"/features/{i + 1}", in_ch, exp, out_ch, k, s,
                                          se, hs, device))
            self.block_names.append(name)
            in_ch = out_ch
        head_ch = 576 if small else 960
        self._add_conv_bn(ctx, f"/features/{len(cfg) + 1}/0", in_ch, head_ch, (1, 1),
                          name_conv="head_conv", name_bn="head_bn", device=device)
        mid = 1024 if small else 1280
        self.pre_classifier = QuantDense(head_ch, mid,
                                         quant=ctx.resolve("/classifier/0", "nn_linear"),
                                         device=device)
        self.classifier = QuantDense(mid, num_classes,
                                     quant=ctx.resolve("/classifier/3", "nn_linear"),
                                     device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        x = hard_swish(self._conv_bn("stem_conv", "stem_bn", x, mode))
        for name in self.block_names:
            x = getattr(self, name)(x, mode)
        x = hard_swish(self._conv_bn("head_conv", "head_bn", x, mode))
        x = hard_swish(self.pre_classifier(x.mean(dim=(1, 2)), mode=mode))
        return self.classifier(x, mode=mode)


def mobilenet_v1(num_classes: int = 1000, ctx: Optional[QuantCtx] = None, device="cuda", **kw):
    return MobileNetV1(num_classes=num_classes, ctx=ctx, device=device, **kw)


def mobilenet_v2(num_classes: int = 1000, ctx: Optional[QuantCtx] = None, device="cuda", **kw):
    return MobileNetV2(num_classes=num_classes, ctx=ctx, device=device, **kw)


def mobilenet_v3_large(num_classes: int = 1000, ctx: Optional[QuantCtx] = None, device="cuda",
                       **kw):
    return MobileNetV3(num_classes=num_classes, small=False, ctx=ctx, device=device, **kw)


def mobilenet_v3_small(num_classes: int = 1000, ctx: Optional[QuantCtx] = None, device="cuda",
                       **kw):
    return MobileNetV3(num_classes=num_classes, small=True, ctx=ctx, device=device, **kw)
