"""Tiny CNNs for fast CPU-runnable end-to-end runs (NHWC).

PyTorch counterpart of ``quantize_tpu/models/testnet.py``: TestCNN, which
``configs/runners/ptq/minmax/ptq_rn18_w8a8_synthetic.yaml`` builds, and
TrajNet, the golden-trajectory fixture net. Module names follow the flax
tree (``conv1``, ``bn1/BatchNorm_0``, ``fc1``), so variables load one to one
from the JAX package (:mod:`quantize_tpu_torch.convert`). JAX infers a
layer's input width; here TestCNN and TrajNet take ``in_ch`` (3).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.intercept import QuantCtx
from ..nn.layers import QuantConv, QuantDense, max_pool_nhwc
from .resnet import _BN, _conv_kind

_PAD1 = [(1, 1), (1, 1)]


class _Net(nn.Module):
    def init_params(self, generator: torch.Generator) -> None:
        """Draw every kernel (lecun normal) from ``generator`` in module
        order; biases zero, BatchNorm at its identity statistics."""
        for mod in self.modules():
            if hasattr(mod, "init_params") and mod is not self:
                mod.init_params(generator)


class TrajNet(_Net):
    """Biased conv(3->8, s2) -> relu -> conv(8->16, s2) -> relu -> GAP -> fc,
    no BN (``quantize_tpu/models/testnet.py:TrajNet``)."""

    def __init__(self, num_classes: int = 10, ctx: Optional[QuantCtx] = None, in_ch: int = 3,
                 device="cuda"):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        kind = _conv_kind(ctx)
        self.conv1 = QuantConv(in_ch, 8, (3, 3), strides=(2, 2), padding=_PAD1, use_bias=True,
                               quant=ctx.resolve("/conv1", kind), device=device)
        self.conv2 = QuantConv(8, 16, (3, 3), strides=(2, 2), padding=_PAD1, use_bias=True,
                               quant=ctx.resolve("/conv2", kind), device=device)
        self.fc = QuantDense(16, num_classes, quant=ctx.resolve("/fc", "nn_linear"),
                             device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        x = torch.relu(self.conv1(x, mode=mode))
        x = torch.relu(self.conv2(x, mode=mode))
        return self.fc(x.mean(dim=(1, 2)), mode=mode)


class TestCNN(_Net):
    """conv(3x3) [-> BN] -> relu -> max pool 2x2 -> conv(3x3) [-> BN] -> relu
    -> GAP -> fc(32) -> relu -> fc; the BNs only when BN folding is off."""

    __test__ = False  # not a pytest test class

    def __init__(self, num_classes: int = 10, width: int = 16, ctx: Optional[QuantCtx] = None,
                 in_ch: int = 3, device="cuda"):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        kind = _conv_kind(ctx)
        self.conv1 = QuantConv(in_ch, width, (3, 3), padding=_PAD1, use_bias=False,
                               quant=ctx.resolve("/conv1", kind), device=device)
        self.conv2 = QuantConv(width, width * 2, (3, 3), padding=_PAD1, use_bias=False,
                               quant=ctx.resolve("/conv2", kind), device=device)
        if not ctx.bn_folding_enabled:
            self.bn1 = _BN(width, device=device)
            self.bn2 = _BN(width * 2, device=device)
        self.fc1 = QuantDense(width * 2, 32, quant=ctx.resolve("/fc1", "nn_linear"),
                              device=device)
        self.fc2 = QuantDense(32, num_classes, quant=ctx.resolve("/fc2", "nn_linear"),
                              device=device)

    def _conv_bn_relu(self, conv: str, bn: str, x: torch.Tensor, mode: str,
                      train: bool) -> torch.Tensor:
        x = getattr(self, conv)(x, mode=mode)
        if hasattr(self, bn):
            x = getattr(self, bn)(x, train)
        return torch.relu(x)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        x = self._conv_bn_relu("conv1", "bn1", x, mode, train)
        x = max_pool_nhwc(x, (2, 2), (2, 2), ((0, 0), (0, 0)))  # flax max_pool: VALID
        x = self._conv_bn_relu("conv2", "bn2", x, mode, train).mean(dim=(1, 2))
        x = torch.relu(self.fc1(x, mode=mode))
        return self.fc2(x, mode=mode)
