"""Quantization-aware ResNet family (NHWC).

PyTorch counterpart of ``quantize_tpu/models/resnet.py``: resnet18/34/50/
101/152, resnext50_32x4d, resnext101_32x8d/64x4d, wide_resnet50_2/101_2,
built quantization-aware from a :class:`~quantize_tpu_torch.nn.intercept.QuantCtx`.
Module names follow the flax tree (``layer1_0/conv1``, ``downsample_conv``,
``fc``), so variables load one to one from the JAX package
(:mod:`quantize_tpu_torch.convert`). With ``ctx.bn_folding_enabled`` the
BatchNorms are absent (folded into the convs); otherwise inference-mode
BatchNorm layers follow each conv. ResNeXt's grouped 3x3 convs run the
grouped int8 conv (kernel K3g) once packed. Under
:func:`~quantize_tpu_torch.nn.precision.qin_carry` the packed blocks take
their identity from conv1's int8 input (dequantized), as JAX's do.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from ..nn.intercept import QuantCtx
from ..nn.layers import (QuantConv, QuantDense, QuantGlobalAvgPool, QuantMaxPool,
                         QuantReLU, max_pool_nhwc)
from ..nn.precision import packed_fused_residual, packed_qin_carry
from ..nn.variables import VarModule


class _BatchNorm(VarModule):
    """flax ``nn.BatchNorm`` (momentum 0.9): on its running statistics, or
    with ``train`` on the batch's, which then move the running ones (what
    flax does under ``mutable=["batch_stats"]``)."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.9, device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        f32 = dict(dtype=torch.float32, device=device)
        self.put_var("params", "scale", torch.ones((features,), **f32))
        self.put_var("params", "bias", torch.zeros((features,), **f32))
        self.put_var("batch_stats", "mean", torch.zeros((features,), **f32))
        self.put_var("batch_stats", "var", torch.ones((features,), **f32))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        mean, var = self.get_var("batch_stats", "mean"), self.get_var("batch_stats", "var")
        if train:
            # flax's statistics over every axis but the channels, in float32,
            # the variance as E[x^2] - E[x]^2 clipped at 0
            axes = tuple(range(x.dim() - 1))
            xf = x.float()
            b_mean = xf.mean(axes)
            b_var = torch.clamp_min(xf.square().mean(axes) - b_mean.square(), 0.0)
            m = self.momentum
            self.put_var("batch_stats", "mean", m * mean + (1 - m) * b_mean.detach())
            self.put_var("batch_stats", "var", m * var + (1 - m) * b_var.detach())
            mean, var = b_mean, b_var
        mul = torch.rsqrt(var + self.eps) * self.get_var("params", "scale")
        return (x - mean) * mul + self.get_var("params", "bias")


class _BN(nn.Module):
    """Wrapper giving the flax path ``<bn name>/BatchNorm_0/...``."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.BatchNorm_0 = _BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.BatchNorm_0(x, train)


def _conv_kind(ctx: QuantCtx) -> str:
    return "nn_conv2d_bn2d" if ctx.bn_folding_enabled else "nn_conv2d"


def _fuse_residual(ctx: QuantCtx, mode: str) -> bool:
    """Gate for the fused conv + residual + ReLU packed tail: requires folded
    BN (nothing between conv and add) and a plain (non-act-quantized) ReLU."""
    return (mode == "packed" and packed_fused_residual()
            and ctx.bn_folding_enabled
            and not ctx.act_layer_enabled("nn_relu"))


class _Stage(nn.Module):
    """Conv (+ BN when not folded) and ReLU sites attached to one module, so
    parameter paths stay flat (``layer1_0/conv1``)."""

    def _add_conv_bn(self, ctx: QuantCtx, qpath: str, in_ch: int, features: int,
                     kernel_size: Sequence[int], strides: Sequence[int] = (1, 1),
                     groups: int = 1, name_conv: str = "conv", name_bn: str = "bn",
                     s2d: bool = False, device=None) -> None:
        pad = [(k // 2, k // 2) for k in kernel_size]
        setattr(self, name_conv, QuantConv(
            in_ch, features, kernel_size=tuple(kernel_size), strides=tuple(strides),
            padding=pad, feature_group_count=groups, use_bias=False,
            quant=ctx.resolve(qpath, _conv_kind(ctx)), s2d=s2d, device=device))
        if not ctx.bn_folding_enabled:
            setattr(self, name_bn, _BN(features, device=device))

    def _conv_bn(self, name_conv: str, name_bn: str, x: torch.Tensor, mode: str,
                 residual=None, fuse_relu: bool = False, return_qinput: bool = False,
                 train: bool = False):
        """The conv (and BN, on the batch's statistics with ``train``); with
        ``return_qinput`` (packed mode, the int8 carry) ``(out, qin)``, qin
        the conv's quantized input or None."""
        conv = getattr(self, name_conv)
        if return_qinput:
            x, qin = conv(x, mode=mode, return_qinput=True)
        else:
            x = conv(x, mode=mode, residual=residual, fuse_relu=fuse_relu)
        if hasattr(self, name_bn):
            x = getattr(self, name_bn)(x, train)
        return (x, qin) if return_qinput else x

    def _add_relu(self, ctx: QuantCtx, qpath: str, name: str, in_ch: int, device=None) -> None:
        """ReLU site: plain by default; an explicit ``nn_relu`` config key
        makes it the activation-quantized :class:`QuantReLU`."""
        if ctx.act_layer_enabled("nn_relu"):
            setattr(self, name, QuantReLU(ctx.resolve(qpath, "nn_relu"), in_ch, device))

    def _relu(self, name: str, x: torch.Tensor, mode: str) -> torch.Tensor:
        if hasattr(self, name):
            return getattr(self, name)(x, mode=mode)
        return torch.relu(x)


class BasicBlock(_Stage):
    def __init__(self, ctx: QuantCtx, qpath: str, in_ch: int, features: int,
                 strides: Sequence[int] = (1, 1), downsample: bool = False, device=None):
        super().__init__()
        self.ctx, self.downsample = ctx, downsample
        self._add_conv_bn(ctx, f"{qpath}/conv1", in_ch, features, (3, 3), strides,
                          name_conv="conv1", name_bn="bn1", device=device)
        self._add_relu(ctx, f"{qpath}/relu", "relu1", features, device)
        if downsample:
            self._add_conv_bn(ctx, f"{qpath}/downsample/0", in_ch, features, (1, 1), strides,
                              name_conv="downsample_conv", name_bn="downsample_bn", device=device)
        self._add_conv_bn(ctx, f"{qpath}/conv2", features, features, (3, 3),
                          name_conv="conv2", name_bn="bn2", device=device)
        self._add_relu(ctx, f"{qpath}/relu", "relu2", features, device)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        # int8 carry: skip/downsample reuse conv1's quantized input
        use_qin = mode == "packed" and packed_qin_carry()
        out = self._conv_bn("conv1", "bn1", x, mode, return_qinput=use_qin, train=train)
        qin = None
        if use_qin:
            out, qin = out
        identity = x if qin is None else qin.dequant()
        out = self._relu("relu1", out, mode)
        if self.downsample:
            identity = self._conv_bn("downsample_conv", "downsample_bn", identity,
                                     mode, train=train)
        if _fuse_residual(self.ctx, mode):
            # 3x3 conv: the fused 1x1 kernel does not apply, but the layer's
            # unfused residual tail still adds and applies ReLU
            return self._conv_bn("conv2", "bn2", out, mode, residual=identity,
                                 fuse_relu=True, train=train)
        out = self._conv_bn("conv2", "bn2", out, mode, train=train)
        return self._relu("relu2", out + identity, mode)


class Bottleneck(_Stage):
    def __init__(self, ctx: QuantCtx, qpath: str, in_ch: int, features: int,
                 out_features: int, strides: Sequence[int] = (1, 1), groups: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        self.ctx, self.downsample = ctx, downsample
        self._add_conv_bn(ctx, f"{qpath}/conv1", in_ch, features, (1, 1),
                          name_conv="conv1", name_bn="bn1", device=device)
        self._add_relu(ctx, f"{qpath}/relu", "relu1", features, device)
        self._add_conv_bn(ctx, f"{qpath}/conv2", features, features, (3, 3), strides,
                          groups=groups, name_conv="conv2", name_bn="bn2", device=device)
        self._add_relu(ctx, f"{qpath}/relu", "relu2", features, device)
        if downsample:
            self._add_conv_bn(ctx, f"{qpath}/downsample/0", in_ch, out_features, (1, 1),
                              strides, name_conv="downsample_conv", name_bn="downsample_bn",
                              device=device)
        self._add_conv_bn(ctx, f"{qpath}/conv3", features, out_features, (1, 1),
                          name_conv="conv3", name_bn="bn3", device=device)
        self._add_relu(ctx, f"{qpath}/relu", "relu3", out_features, device)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        use_qin = mode == "packed" and packed_qin_carry()
        out = self._conv_bn("conv1", "bn1", x, mode, return_qinput=use_qin, train=train)
        qin = None
        if use_qin:
            out, qin = out
        identity = x if qin is None else qin.dequant()
        out = self._relu("relu1", out, mode)
        out = self._conv_bn("conv2", "bn2", out, mode, train=train)
        out = self._relu("relu2", out, mode)
        if self.downsample:
            identity = self._conv_bn("downsample_conv", "downsample_bn", identity,
                                     mode, train=train)
        if _fuse_residual(self.ctx, mode):
            # conv3 + skip add + ReLU in one kernel: the fat block-boundary
            # activation is written to device memory exactly once
            return self._conv_bn("conv3", "bn3", out, mode, residual=identity,
                                 fuse_relu=True, train=train)
        out = self._conv_bn("conv3", "bn3", out, mode, train=train)
        return self._relu("relu3", out + identity, mode)


class ResNet(_Stage):
    """Torchvision-compatible ResNet/ResNeXt/WideResNet trunk over NHWC input.

    ``stem_s2d``: packed inference rewrites the 7x7/s2 stem as a stride-1
    4x4 conv over a 2x2 space-to-depth input (exact math).
    """

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool, num_classes: int = 1000,
                 groups: int = 1, width_per_group: int = 64, stem_width: int = 64,
                 stem_s2d: bool = True, ctx: Optional[QuantCtx] = None, in_channels: int = 3,
                 device="cuda"):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        self.ctx = ctx
        device = torch.device(device)
        self._add_conv_bn(ctx, "/conv1", in_channels, stem_width, (7, 7), (2, 2),
                          name_conv="conv1", name_bn="bn1", s2d=stem_s2d, device=device)
        self._add_relu(ctx, "/relu", "relu", stem_width, device)
        if ctx.act_layer_enabled("nn_maxpool2d"):
            self.maxpool = QuantMaxPool((3, 3), (2, 2), [(1, 1), (1, 1)],
                                        ctx.resolve("/maxpool", "nn_maxpool2d"), stem_width, device)
        expansion = 4 if bottleneck else 1
        in_ch = stem_width
        self.block_names = []
        for stage, n_blocks in enumerate(stage_sizes):
            planes = 64 * (2 ** stage)
            width = int(planes * (width_per_group / 64.0)) * groups
            out_ch = planes * expansion
            for b in range(n_blocks):
                strides = (2, 2) if (stage > 0 and b == 0) else (1, 1)
                path = f"/layer{stage + 1}/{b}"
                needs_ds = b == 0 and (strides != (1, 1) or in_ch != out_ch)
                if bottleneck:
                    block = Bottleneck(ctx, path, in_ch, width, out_ch, strides, groups,
                                       needs_ds, device)
                else:
                    block = BasicBlock(ctx, path, in_ch, planes, strides, needs_ds, device)
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, block)
                self.block_names.append(name)
                in_ch = out_ch
        if ctx.act_layer_enabled("nn_adaptiveavgpool2d"):
            self.avgpool = QuantGlobalAvgPool(ctx.resolve("/avgpool", "nn_adaptiveavgpool2d"),
                                              in_ch, device)
        self.fc = QuantDense(in_ch, num_classes, quant=ctx.resolve("/fc", "nn_linear"),
                             device=device)

    def init_params(self, generator: torch.Generator) -> None:
        """Draw every kernel (lecun normal) from ``generator`` in module
        order; biases zero, BatchNorm at its identity statistics."""
        for mod in self.modules():
            if hasattr(mod, "init_params") and mod is not self:
                mod.init_params(generator)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        x = self._conv_bn("conv1", "bn1", x, mode, train=train)
        x = self._relu("relu", x, mode)
        if hasattr(self, "maxpool"):
            x = self.maxpool(x, mode=mode)
        else:
            x = max_pool_nhwc(x, (3, 3), (2, 2), [(1, 1), (1, 1)])
        for name in self.block_names:
            x = getattr(self, name)(x, mode, train)
        if hasattr(self, "avgpool"):
            x = self.avgpool(x, mode=mode)
        else:
            x = x.mean(dim=(1, 2))
        return self.fc(x, mode=mode)


def _make(stage_sizes, bottleneck, **kw) -> Callable[..., ResNet]:
    def ctor(num_classes: int = 1000, ctx: Optional[QuantCtx] = None, device="cuda",
             **extra: Any) -> ResNet:
        return ResNet(stage_sizes=stage_sizes, bottleneck=bottleneck, num_classes=num_classes,
                      ctx=ctx or QuantCtx.fp32(), device=device, **{**kw, **extra})

    return ctor


resnet18 = _make([2, 2, 2, 2], False)
resnet34 = _make([3, 4, 6, 3], False)
resnet50 = _make([3, 4, 6, 3], True)
resnet101 = _make([3, 4, 23, 3], True)
resnet152 = _make([3, 8, 36, 3], True)
resnext50_32x4d = _make([3, 4, 6, 3], True, groups=32, width_per_group=4)
resnext101_32x8d = _make([3, 4, 23, 3], True, groups=32, width_per_group=8)
resnext101_64x4d = _make([3, 4, 23, 3], True, groups=64, width_per_group=4)
wide_resnet50_2 = _make([3, 4, 6, 3], True, width_per_group=128)
wide_resnet101_2 = _make([3, 4, 23, 3], True, width_per_group=128)
