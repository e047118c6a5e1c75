"""Quantization-aware Vision Transformer (torchvision-compatible, NHWC input).

PyTorch counterpart of ``quantize_tpu/models/vit.py``: vit_b_16/32,
vit_l_16/32 and vit_h_14, built quantization-aware from a
:class:`~quantize_tpu_torch.nn.intercept.QuantCtx`. The quantized sites are
the patch-embedding conv, every MLP linear, the attention blocks and the
head; LayerNorms stay in float. Config paths follow torchvision naming
(``/conv_proj``, ``/encoder/layers/encoder_layer_0/self_attention``,
``.../mlp/0``, ``/heads/head``), so regex-scoped overrides resolve as in
the JAX package, and module names follow the flax tree (``conv_proj``,
``encoder_layer_0/self_attention/q_proj``, ``ln``, ``head``; the root holds
``class_token`` and ``pos_embedding``).

In packed mode the float glue ops (residuals, embeddings, LayerNorm
outputs) run in the carry dtype; the sequence is padded to a multiple of 8
(197 -> 200) and the encoder carries 2-D ``(B*S_pad, E)`` rows, each block
deferring its LayerNorms into their consumers (``pre_norm``); the MLP uses
the tanh-approximate GELU, every other mode the exact erf GELU.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import QuantMultiheadAttention
from ..nn.intercept import QuantCtx
from ..nn.layers import QuantConv, QuantDense
from ..nn.norm import FusedLayerNorm
from ..nn.precision import packed_carry_dtype
from ..nn.variables import VarModule


def _compute_dtype(mode: str) -> Optional[torch.dtype]:
    """The carry dtype in packed mode, None (float32 promotion) otherwise."""
    return packed_carry_dtype() if mode == "packed" else None


class MLPBlock(nn.Module):
    def __init__(self, ctx: QuantCtx, qpath: str, in_dim: int, hidden_dim: int, out_dim: int,
                 device=None):
        super().__init__()
        self.linear1 = QuantDense(in_dim, hidden_dim,
                                  quant=ctx.resolve(f"{qpath}/0", "nn_linear"), device=device)
        self.linear2 = QuantDense(hidden_dim, out_dim,
                                  quant=ctx.resolve(f"{qpath}/3", "nn_linear"), device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32", pre_norm=None) -> torch.Tensor:
        x = self.linear1(x, mode=mode, pre_norm=pre_norm)
        # packed inference: tanh-approximate GELU (its ~1e-3 relative error is
        # far below the int8 noise of the matmul that consumes it); the
        # simulation modes keep the exact erf GELU
        x = F.gelu(x, approximate="tanh" if mode == "packed" else "none")
        return self.linear2(x, mode=mode)


class EncoderBlock(nn.Module):
    def __init__(self, ctx: QuantCtx, qpath: str, num_heads: int, hidden_dim: int, mlp_dim: int,
                 device=None):
        super().__init__()
        self.ln_1 = FusedLayerNorm(hidden_dim, epsilon=1e-6, device=device)
        self.self_attention = QuantMultiheadAttention(
            hidden_dim, num_heads,
            quant=ctx.resolve(f"{qpath}/self_attention", "nn_multiheadattention"), device=device)
        self.ln_2 = FusedLayerNorm(hidden_dim, epsilon=1e-6, device=device)
        self.mlp = MLPBlock(ctx, f"{qpath}/mlp", hidden_dim, mlp_dim, hidden_dim, device)

    def forward(self, x: torch.Tensor, mode: str = "fp32", seq_len: int = 0,
                valid_len: int = 0) -> torch.Tensor:
        if mode == "packed":
            # each LayerNorm is deferred into its consumer, where it fuses
            # with the int8 activation quantize; x is (B*S_pad, E) rows
            x = x + self.self_attention(x, mode=mode, pre_norm=self.ln_1.params_tuple(),
                                        seq_len=seq_len, valid_len=valid_len)
            return x + self.mlp(x, mode=mode, pre_norm=self.ln_2.params_tuple())
        x = x + self.self_attention(self.ln_1(x, mode), mode=mode)
        return x + self.mlp(self.ln_2(x, mode), mode=mode)


class VisionTransformer(VarModule):
    def __init__(self, image_size: int = 224, patch_size: int = 16, num_layers: int = 12,
                 num_heads: int = 12, hidden_dim: int = 768, mlp_dim: int = 3072,
                 num_classes: int = 1000, ctx: Optional[QuantCtx] = None, in_channels: int = 3,
                 device="cuda"):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        device = torch.device(device)
        self.hidden_dim = hidden_dim
        self.conv_proj = QuantConv(in_channels, hidden_dim, (patch_size, patch_size),
                                   strides=(patch_size, patch_size), padding="VALID",
                                   quant=ctx.resolve("/conv_proj", "nn_conv2d"), device=device)
        seq_len = (image_size // patch_size) ** 2 + 1
        f32 = dict(dtype=torch.float32, device=device)
        self.put_var("params", "class_token", torch.zeros((1, 1, hidden_dim), **f32))
        self.put_var("params", "pos_embedding", torch.zeros((1, seq_len, hidden_dim), **f32))
        self.layer_names = []
        for i in range(num_layers):
            name = f"encoder_layer_{i}"
            setattr(self, name, EncoderBlock(ctx, f"/encoder/layers/{name}", num_heads,
                                             hidden_dim, mlp_dim, device))
            self.layer_names.append(name)
        self.ln = FusedLayerNorm(hidden_dim, epsilon=1e-6, device=device)
        self.head = QuantDense(hidden_dim, num_classes, quant=ctx.resolve("/heads/head", "nn_linear"),
                               device=device)

    def init_params(self, generator: torch.Generator) -> None:
        """Draw the parameters from ``generator``: lecun-normal kernels (in
        module order), zero biases and class token, LayerNorm at identity,
        and the position embedding from normal(0, 0.02)."""
        for mod in self.modules():
            if hasattr(mod, "init_params") and mod is not self:
                mod.init_params(generator)
        pos = self.get_var("params", "pos_embedding")
        with torch.no_grad():
            self.get_var("params", "class_token").zero_()
            pos.copy_(torch.randn(pos.shape, generator=generator) * 0.02)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        del train  # no BatchNorm
        n = x.shape[0]
        x = self.conv_proj(x, mode=mode)
        x = x.reshape(n, -1, self.hidden_dim)  # (N, patches, E)
        dt = _compute_dtype(mode)
        cls = self.get_var("params", "class_token")
        pos = self.get_var("params", "pos_embedding")
        if dt is not None:
            cls, pos = cls.to(dt), pos.to(dt)
        x = torch.cat([cls.expand(n, 1, self.hidden_dim).to(x.dtype), x], dim=1)
        seq_len = x.shape[1]
        x = x + pos
        s_pad = seq_len
        if mode == "packed":
            # 2-D (B*S_pad, E) rows through the whole encoder; pad keys are
            # masked in the attention kernel (valid_len), pad query rows stay
            # finite and isolated, and the cls gather drops them
            s_pad = -(-seq_len // 8) * 8
            x = F.pad(x, (0, 0, 0, s_pad - seq_len)).reshape(n * s_pad, self.hidden_dim)
        for name in self.layer_names:
            x = getattr(self, name)(x, mode=mode, seq_len=s_pad, valid_len=seq_len)
        x = self.ln(x, mode)
        x = x[::s_pad] if mode == "packed" else x[:, 0]
        return self.head(x, mode=mode)


def _make_vit(patch: int, layers: int, heads: int, hidden: int, mlp: int,
              image_size: int = 224) -> Callable[..., VisionTransformer]:
    def ctor(num_classes: int = 1000, ctx: Optional[QuantCtx] = None, device="cuda",
             **kw) -> VisionTransformer:
        return VisionTransformer(image_size=kw.pop("image_size", image_size), patch_size=patch,
                                 num_layers=layers, num_heads=heads, hidden_dim=hidden,
                                 mlp_dim=mlp, num_classes=num_classes, ctx=ctx or QuantCtx.fp32(),
                                 device=device, **kw)

    return ctor


vit_b_16 = _make_vit(16, 12, 12, 768, 3072)
vit_b_32 = _make_vit(32, 12, 12, 768, 3072)
vit_l_16 = _make_vit(16, 24, 16, 1024, 4096)
vit_l_32 = _make_vit(32, 24, 16, 1024, 4096)
vit_h_14 = _make_vit(14, 32, 16, 1280, 5120)
