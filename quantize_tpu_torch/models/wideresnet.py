"""Pre-activation WideResNet (CIFAR), quantization-aware.

PyTorch counterpart of ``quantize_tpu/models/wideresnet.py``: the
reference's custom WRN-28/40 and the RobustBench ``rb_wrn-28-10`` entry
(the same WRN-28-10 architecture; its weights come from a user-provided
torch checkpoint).

BN-folding topology, as the JAX package reproduces it from the reference:
in pre-activation blocks BN precedes conv in module order, so the
sibling-pair fold puts ``bn2`` into ``conv1`` (the BN that follows conv1
in the dataflow) and leaves each block's ``bn1`` a live BatchNorm;
``conv2`` and the shortcut stay unfolded.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn.intercept import QuantCtx
from ..nn.layers import QuantConv, QuantDense
from .resnet import ResNet, _BN, _conv_kind


class WRNBasicBlock(torch.nn.Module):
    def __init__(self, ctx: QuantCtx, qpath: str, in_planes: int, out_planes: int,
                 stride: int = 1, device=None):
        super().__init__()
        self.equal = in_planes == out_planes
        self.bn1 = _BN(in_planes, device=device)
        # conv1 (+ bn2 folded into it when bn_folding is on)
        self.conv1 = QuantConv(in_planes, out_planes, (3, 3), strides=(stride, stride),
                               padding=[(1, 1), (1, 1)], use_bias=False,
                               quant=ctx.resolve(f"{qpath}/conv1", _conv_kind(ctx)),
                               device=device)
        if not ctx.bn_folding_enabled:
            self.bn2 = _BN(out_planes, device=device)
        self.conv2 = QuantConv(out_planes, out_planes, (3, 3), padding=[(1, 1), (1, 1)],
                               use_bias=False, quant=ctx.resolve(f"{qpath}/conv2", "nn_conv2d"),
                               device=device)
        if not self.equal:
            self.convShortcut = QuantConv(in_planes, out_planes, (1, 1),
                                          strides=(stride, stride), padding="VALID",
                                          use_bias=False,
                                          quant=ctx.resolve(f"{qpath}/convShortcut",
                                                            "nn_conv2d"),
                                          device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        pre = torch.relu(self.bn1(x, train))
        out = self.conv1(pre, mode=mode)
        if hasattr(self, "bn2"):
            out = self.bn2(out, train)
        out = self.conv2(torch.relu(out), mode=mode)
        shortcut = x if self.equal else self.convShortcut(pre, mode=mode)
        return shortcut + out


class WideResNet(torch.nn.Module):
    def __init__(self, depth: int = 28, widen_factor: int = 10, num_classes: int = 10,
                 ctx: Optional[QuantCtx] = None, in_channels: int = 3, device="cuda"):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        device = torch.device(device)
        if (depth - 4) % 6:
            raise ValueError(f"WideResNet depth {depth}: (depth - 4) must be a multiple of 6")
        n = (depth - 4) // 6
        widths = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        self.conv1 = QuantConv(in_channels, widths[0], (3, 3), padding=[(1, 1), (1, 1)],
                               use_bias=False, quant=ctx.resolve("/conv1", "nn_conv2d"),
                               device=device)
        in_planes = widths[0]
        self.block_names = []
        for stage in range(3):
            out_planes = widths[stage + 1]
            stride = 1 if stage == 0 else 2
            for b in range(n):
                name = f"block{stage + 1}_{b}"
                setattr(self, name, WRNBasicBlock(ctx, f"/block{stage + 1}/layer/{b}", in_planes,
                                                  out_planes, stride if b == 0 else 1, device))
                self.block_names.append(name)
                in_planes = out_planes
        self.bn1 = _BN(in_planes, device=device)
        self.fc = QuantDense(in_planes, num_classes, quant=ctx.resolve("/fc", "nn_linear"),
                             device=device)

    # kernels drawn in module order, as ResNet's
    init_params = ResNet.init_params

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        x = self.conv1(x, mode=mode)
        for name in self.block_names:
            x = getattr(self, name)(x, mode, train)
        x = torch.relu(self.bn1(x, train))
        return self.fc(x.mean(dim=(1, 2)), mode=mode)


def wideresnet28(num_classes: int = 10, ctx: Optional[QuantCtx] = None, device="cuda", **kw):
    return WideResNet(depth=28, widen_factor=kw.pop("widen_factor", 10), num_classes=num_classes,
                      ctx=ctx, device=device, **kw)


def wideresnet40(num_classes: int = 10, ctx: Optional[QuantCtx] = None, device="cuda", **kw):
    return WideResNet(depth=40, widen_factor=kw.pop("widen_factor", 2), num_classes=num_classes,
                      ctx=ctx, device=device, **kw)


def rb_wrn_28_10(num_classes: int = 10, ctx: Optional[QuantCtx] = None, device="cuda", **kw):
    """RobustBench 'Standard' WRN-28-10 architecture (weights via torch
    checkpoint import)."""
    return wideresnet28(num_classes=num_classes, ctx=ctx, device=device, **kw)
