"""CLIP architecture (vision and text towers), quantization-aware (NHWC input).

PyTorch counterpart of ``quantize_tpu/models/clip/model.py``: ``ModifiedResNet``
(3-conv stem with an average pool, anti-aliased bottlenecks, attention
pooling), the CLIP ``VisionTransformer``, the causal text transformer,
QuickGELU MLPs and the ``logit_scale``-scaled contrastive head. Every conv,
linear and attention site is quantization-aware through
:class:`~quantize_tpu_torch.nn.intercept.QuantCtx`; the LayerNorms
``ln_pre``, ``ln_post`` and ``ln_final`` (flax's ``nn.LayerNorm``:
:class:`~quantize_tpu_torch.nn.norm.LayerNorm`) and the ``proj`` /
``text_projection`` matrices stay float.

Config paths (``/visual/conv1``, ``/visual/layer1/0/conv1``,
``/visual/transformer/resblocks/0/attn``, ``/transformer/resblocks/0/mlp/c_fc``)
and module names (``visual/transformer/resblock_0/attn/q_proj``,
``visual/layer1_0/downsample_conv``, ``token_embedding/embedding``) follow
the JAX package's, so regex overrides resolve and variables load as there.

In packed mode the ViT and text towers carry 2-D ``(B*S_pad, E)`` rows
(S padded to a multiple of 8: 197 -> 200 for the image at 224, 77 -> 80
for text) with pad keys masked in the attention kernel; each block defers
its two LayerNorms into their consumers (kernel K7). The text tower runs
the fused attention with its causal mask (kernel K8, ``causal=True``).
The float glue ops follow JAX's CLIP, with no casts of their own: the
class and position embeddings, ``ln_pre`` and the residual stream promote
to float32 whatever the carry dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.attention import QuantMultiheadAttention
from ...nn.intercept import QuantCtx
from ...nn.layers import QuantConv, QuantDense
from ...nn.norm import FusedLayerNorm, LayerNorm
from ...nn.variables import VarModule
from ..resnet import _Stage


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def causal_mask(n: int, device=None) -> torch.Tensor:
    """The additive (n, n) causal mask: -inf above the diagonal."""
    return torch.triu(torch.full((n, n), float("-inf"), device=device), diagonal=1)


def _f32(v: float, device) -> torch.Tensor:
    """A float32 scalar tensor, to divide by (on CUDA PyTorch turns a
    division by a Python scalar into a multiplication by the reciprocal)."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / jnp.linalg.norm(x, axis=-1, keepdims=True)``: the square root
    of the sum of squares, as JAX forms it."""
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True))


def scaled(logit_scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``exp(logit_scale) * x`` in JAX's promotion: the float32 scale makes
    a bf16 ``x`` (the RN tower's output at bf16 carry) float32."""
    return torch.exp(logit_scale) * x.to(torch.promote_types(x.dtype, logit_scale.dtype))


def avg_pool_nhwc(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax's ``nn.avg_pool(x, (k, k), (k, k))`` (VALID): the window summed
    in row-major order, then divided by k * k."""
    n, h, w, c = x.shape
    oh, ow = h // k, w // k
    x = x[:, :oh * k, :ow * k]
    acc = None
    for i in range(k):
        for j in range(k):
            tap = x[:, i::k, j::k]
            acc = tap if acc is None else acc + tap
    return acc / _f32(float(k * k), x.device).to(acc.dtype)


def _normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


class Embed(VarModule):
    """flax ``nn.Embed``: a (vocab, features) table under ``embedding``."""

    def __init__(self, num_embeddings: int, features: int, device=None):
        super().__init__()
        self.put_var("params", "embedding",
                     torch.zeros((num_embeddings, features), dtype=torch.float32, device=device))

    def init_params(self, generator: torch.Generator) -> None:
        _normal_(self.get_var("params", "embedding"), 0.02, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.get_var("params", "embedding")[ids.long()]


class CLIPBottleneck(_Stage):
    """CLIP's anti-aliased bottleneck: all convs stride 1, an average pool
    after conv2 when stride > 1, and an average pool before the downsample."""

    def __init__(self, ctx: QuantCtx, qpath: str, in_ch: int, planes: int, out_planes: int,
                 stride: int = 1, downsample: bool = False, device=None):
        super().__init__()
        self.stride, self.downsample = stride, downsample
        self._add_conv_bn(ctx, f"{qpath}/conv1", in_ch, planes, (1, 1),
                          name_conv="conv1", name_bn="bn1", device=device)
        self._add_conv_bn(ctx, f"{qpath}/conv2", planes, planes, (3, 3),
                          name_conv="conv2", name_bn="bn2", device=device)
        self._add_conv_bn(ctx, f"{qpath}/conv3", planes, out_planes, (1, 1),
                          name_conv="conv3", name_bn="bn3", device=device)
        if downsample:
            self._add_conv_bn(ctx, f"{qpath}/downsample/0", in_ch, out_planes, (1, 1),
                              name_conv="downsample_conv", name_bn="downsample_bn",
                              device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        identity = x
        out = torch.relu(self._conv_bn("conv1", "bn1", x, mode, train=train))
        out = torch.relu(self._conv_bn("conv2", "bn2", out, mode, train=train))
        if self.stride > 1:
            out = avg_pool_nhwc(out, self.stride)
        out = self._conv_bn("conv3", "bn3", out, mode, train=train)
        if self.downsample:
            if self.stride > 1:
                identity = avg_pool_nhwc(identity, self.stride)
            identity = self._conv_bn("downsample_conv", "downsample_bn", identity,
                                     mode, train=train)
        return torch.relu(out + identity)


class AttentionPool2d(VarModule):
    """QKV attention pooling: the query is the mean token; four quantized
    linears (q/k/v/c projections)."""

    def __init__(self, ctx: QuantCtx, qpath: str, spatial: int, embed_dim: int, num_heads: int,
                 output_dim: int, device=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.put_var("params", "positional_embedding",
                     torch.zeros((spatial + 1, embed_dim), dtype=torch.float32, device=device))
        for name, out in (("q_proj", embed_dim), ("k_proj", embed_dim), ("v_proj", embed_dim),
                          ("c_proj", output_dim)):
            setattr(self, name, QuantDense(embed_dim, out,
                                           quant=ctx.resolve(f"{qpath}/{name}", "nn_linear"),
                                           device=device))

    def init_params(self, generator: torch.Generator) -> None:
        pos = self.get_var("params", "positional_embedding")
        _normal_(pos, pos.shape[1] ** -0.5, generator)

    def forward(self, x: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        n, h, w, c = x.shape
        seq = x.reshape(n, h * w, c)
        # jnp.mean: a float32 sum divided by the count, in the input's dtype
        mean = (seq.float().sum(dim=1, keepdim=True) / _f32(float(h * w), x.device)).to(seq.dtype)
        seq = torch.cat([mean, seq], dim=1) + self.get_var("params", "positional_embedding")
        q = self.q_proj(seq[:, :1], mode=mode)
        k = self.k_proj(seq, mode=mode)
        v = self.v_proj(seq, mode=mode)
        hd = self.embed_dim // self.num_heads

        def heads(t):
            return t.reshape(n, -1, self.num_heads, hd).transpose(1, 2)

        scores = torch.einsum("bhqd,bhkd->bhqk", heads(q), heads(k))
        # JAX divides by a float32 numpy scalar: a bf16 carry's scores and
        # everything after them promote to float32
        scores = scores.float() / _f32(float(np.sqrt(hd)), x.device)
        # jax.nn.softmax's order: exp(x - max) / sum
        ex = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        attn = ex / ex.sum(dim=-1, keepdim=True)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, heads(v).float())
        out = out.transpose(1, 2).reshape(n, 1, self.embed_dim)[:, 0]
        return self.c_proj(out, mode=mode)


class ModifiedResNet(_Stage):
    """CLIP's ResNet visual tower (``/visual/...``)."""

    def __init__(self, layers: Sequence[int], output_dim: int, heads: int, width: int = 64,
                 image_size: int = 224, ctx: Optional[QuantCtx] = None, in_channels: int = 3,
                 device=None):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        self._add_conv_bn(ctx, "/visual/conv1", in_channels, width // 2, (3, 3), (2, 2),
                          name_conv="conv1", name_bn="bn1", device=device)
        self._add_conv_bn(ctx, "/visual/conv2", width // 2, width // 2, (3, 3),
                          name_conv="conv2", name_bn="bn2", device=device)
        self._add_conv_bn(ctx, "/visual/conv3", width // 2, width, (3, 3),
                          name_conv="conv3", name_bn="bn3", device=device)
        in_planes = width
        self.block_names = []
        for stage, n_blocks in enumerate(layers):
            planes = width * (2 ** stage)
            out_planes = planes * 4
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s > 1 or in_planes != out_planes)
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, CLIPBottleneck(ctx, f"/visual/layer{stage + 1}/{b}", in_planes,
                                                   planes, out_planes, s, ds, device))
                self.block_names.append(name)
                in_planes = out_planes
        # the stem halves the image three times (stride-2 conv, average pool)
        # and stages 2-4 once each
        side = image_size // 32
        self.attnpool = AttentionPool2d(ctx, "/visual/attnpool", side * side, width * 32, heads,
                                        output_dim, device)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        for i in (1, 2, 3):
            x = torch.relu(self._conv_bn(f"conv{i}", f"bn{i}", x, mode, train=train))
        x = avg_pool_nhwc(x, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, mode, train)
        return self.attnpool(x, mode=mode)


class ResidualAttentionBlock(nn.Module):
    """ln -> attention -> residual; ln -> QuickGELU MLP -> residual."""

    def __init__(self, ctx: QuantCtx, qpath: str, d_model: int, n_head: int, device=None):
        super().__init__()
        self.ln_1 = FusedLayerNorm(d_model, epsilon=1e-5, device=device)
        self.ln_2 = FusedLayerNorm(d_model, epsilon=1e-5, device=device)
        self.attn = QuantMultiheadAttention(
            d_model, n_head, quant=ctx.resolve(f"{qpath}/attn", "nn_multiheadattention"),
            device=device)
        self.c_fc = QuantDense(d_model, d_model * 4,
                               quant=ctx.resolve(f"{qpath}/mlp/c_fc", "nn_linear"), device=device)
        self.c_proj = QuantDense(d_model * 4, d_model,
                                 quant=ctx.resolve(f"{qpath}/mlp/c_proj", "nn_linear"),
                                 device=device)

    def forward(self, x: torch.Tensor, mode: str = "fp32", mask=None, seq_len: int = 0,
                valid_len: int = 0) -> torch.Tensor:
        if mode == "packed":
            # each LayerNorm defers into its consumer's int8 quantize (K7);
            # x may be 2-D (B*S_pad, E) rows with seq_len set
            x = x + self.attn(x, mode=mode, mask=mask, pre_norm=self.ln_1.params_tuple(),
                              seq_len=seq_len, valid_len=valid_len)
            h = self.c_fc(x, mode=mode, pre_norm=self.ln_2.params_tuple())
        else:
            x = x + self.attn(self.ln_1(x, mode), mode=mode, mask=mask)
            h = self.c_fc(self.ln_2(x, mode), mode=mode)
        return x + self.c_proj(quick_gelu(h), mode=mode)


class CLIPTransformer(nn.Module):
    def __init__(self, ctx: QuantCtx, qpath: str, width: int, layers: int, heads: int,
                 device=None):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            setattr(self, f"resblock_{i}",
                    ResidualAttentionBlock(ctx, f"{qpath}/resblocks/{i}", width, heads, device))

    def forward(self, x: torch.Tensor, mode: str = "fp32", mask=None, seq_len: int = 0,
                valid_len: int = 0) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x, mode=mode, mask=mask, seq_len=seq_len,
                                               valid_len=valid_len)
        return x


def _pad_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(N, S, E) -> 2-D (N*S_pad, E) rows, S padded to a multiple of 8."""
    n, s_len, e = x.shape
    s_pad = -(-s_len // 8) * 8
    return F.pad(x, (0, 0, 0, s_pad - s_len)).reshape(n * s_pad, e), s_pad


class CLIPVisionTransformer(VarModule):
    """CLIP's ViT tower: patch conv without bias, class and position
    embeddings, ``ln_pre``, the transformer, ``ln_post`` on the class token
    and ``@ proj``."""

    def __init__(self, patch_size: int, width: int, layers: int, heads: int, output_dim: int,
                 image_size: int = 224, ctx: Optional[QuantCtx] = None, in_channels: int = 3,
                 device=None):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        self.width = width
        self.conv1 = QuantConv(in_channels, width, (patch_size, patch_size),
                               strides=(patch_size, patch_size), padding="VALID", use_bias=False,
                               quant=ctx.resolve("/visual/conv1", "nn_conv2d"), device=device)
        f32 = dict(dtype=torch.float32, device=device)
        seq_len = (image_size // patch_size) ** 2 + 1
        self.put_var("params", "class_embedding", torch.zeros((width,), **f32))
        self.put_var("params", "positional_embedding", torch.zeros((seq_len, width), **f32))
        self.ln_pre = LayerNorm(width, epsilon=1e-5, device=device)
        self.transformer = CLIPTransformer(ctx, "/visual/transformer", width, layers, heads,
                                           device)
        self.ln_post = LayerNorm(width, epsilon=1e-5, device=device)
        self.put_var("params", "proj", torch.zeros((width, output_dim), **f32))

    def init_params(self, generator: torch.Generator) -> None:
        scale = self.width ** -0.5
        for leaf in ("class_embedding", "positional_embedding", "proj"):
            _normal_(self.get_var("params", leaf), scale, generator)

    def forward(self, x: torch.Tensor, mode: str = "fp32", train: bool = False) -> torch.Tensor:
        del train  # no BatchNorm
        n = x.shape[0]
        x = self.conv1(x, mode=mode).reshape(n, -1, self.width)
        cls = self.get_var("params", "class_embedding")
        dt = torch.promote_types(cls.dtype, x.dtype)  # jnp.concatenate's promotion
        x = torch.cat([cls.to(dt).expand(n, 1, self.width), x.to(dt)], dim=1)
        x = self.ln_pre(x + self.get_var("params", "positional_embedding"))
        s_len = x.shape[1]
        s_pad = s_len
        packed = mode == "packed"
        if packed:
            x, s_pad = _pad_rows(x)
        x = self.transformer(x, mode=mode, seq_len=s_pad, valid_len=s_len)
        x = x[::s_pad] if packed else x[:, 0]
        return self.ln_post(x) @ self.get_var("params", "proj")


class CLIP(VarModule):
    """Full CLIP: vision tower + causal text transformer."""

    def __init__(self, embed_dim: int, vision_layers: Union[Tuple[int, ...], int],
                 vision_width: int, vision_patch_size: int, context_length: int,
                 vocab_size: int, transformer_width: int, transformer_heads: int,
                 transformer_layers: int, image_size: int = 224, ctx: Optional[QuantCtx] = None,
                 device=None):
        super().__init__()
        ctx = ctx or QuantCtx.fp32()
        if isinstance(vision_layers, (tuple, list)):
            self.visual = ModifiedResNet(vision_layers, embed_dim, vision_width * 32 // 64,
                                         vision_width, image_size, ctx, device=device)
        else:
            self.visual = CLIPVisionTransformer(vision_patch_size, vision_width, vision_layers,
                                                vision_width // 64, embed_dim, image_size, ctx,
                                                device=device)
        self.transformer = CLIPTransformer(ctx, "/transformer", transformer_width,
                                           transformer_layers, transformer_heads, device)
        self.token_embedding = Embed(vocab_size, transformer_width, device)
        f32 = dict(dtype=torch.float32, device=device)
        self.put_var("params", "positional_embedding",
                     torch.zeros((context_length, transformer_width), **f32))
        self.ln_final = LayerNorm(transformer_width, epsilon=1e-5, device=device)
        self.put_var("params", "text_projection",
                     torch.zeros((transformer_width, embed_dim), **f32))
        self.put_var("params", "logit_scale", torch.tensor(math.log(1 / 0.07), **f32))

    def init_params(self, generator: torch.Generator) -> None:
        """Draw the parameters from ``generator`` with JAX's initializers'
        scales: kernels lecun normal (in module order), position and class
        embeddings and projections normal(width^-0.5), the token embedding
        normal(0.02), the text position embedding normal(0.01), LayerNorms
        at identity, ``logit_scale`` log(1 / 0.07)."""
        for mod in self.modules():
            if hasattr(mod, "init_params") and mod is not self:
                mod.init_params(generator)
        pos, proj = self.get_var("params", "positional_embedding"), self.get_var(
            "params", "text_projection")
        _normal_(pos, 0.01, generator)
        _normal_(proj, proj.shape[0] ** -0.5, generator)
        with torch.no_grad():
            self.get_var("params", "logit_scale").fill_(math.log(1 / 0.07))

    def encode_image(self, image: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        return self.visual(image, mode=mode)

    def encode_text(self, text: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        """text: (N, context_length) int tokens; the features at the EOT
        position (the highest token id)."""
        x = self.token_embedding(text)
        x = x + self.get_var("params", "positional_embedding")[: x.shape[1]]
        n, s_len = x.shape[0], x.shape[1]
        s_pad = s_len
        packed = mode == "packed"
        if packed:
            x, s_pad = _pad_rows(x)
        # "causal": packed mode runs kernel K8 with its in-kernel causal mask
        # (pad keys masked too); the other modes add the (S, S) mask
        x = self.transformer(x, mode=mode, mask="causal", seq_len=s_pad, valid_len=s_len)
        x = self.ln_final(x)
        eot = text.argmax(dim=-1)
        rows = torch.arange(n, device=x.device)
        x = x[rows * s_pad + eot] if packed else x[rows, eot]
        return x @ self.get_var("params", "text_projection")

    def forward(self, image: torch.Tensor, text: torch.Tensor, mode: str = "fp32"):
        img = l2_normalize(self.encode_image(image, mode))
        txt = l2_normalize(self.encode_text(text, mode))
        logits_per_image = scaled(self.get_var("params", "logit_scale"), img) @ txt.T
        return logits_per_image, logits_per_image.T


# backbone name -> constructor kwargs (the reference's clip/clip.py model set)
CLIP_CONFIGS = {
    "RN50": dict(embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64,
                 vision_patch_size=0, context_length=77, vocab_size=49408,
                 transformer_width=512, transformer_heads=8, transformer_layers=12),
    "RN101": dict(embed_dim=512, vision_layers=(3, 4, 23, 3), vision_width=64,
                  vision_patch_size=0, context_length=77, vocab_size=49408,
                  transformer_width=512, transformer_heads=8, transformer_layers=12),
    "RN50x4": dict(embed_dim=640, vision_layers=(4, 6, 10, 6), vision_width=80,
                   vision_patch_size=0, context_length=77, vocab_size=49408,
                   transformer_width=640, transformer_heads=10, transformer_layers=12),
    "RN50x16": dict(embed_dim=768, vision_layers=(6, 8, 18, 8), vision_width=96,
                    vision_patch_size=0, context_length=77, vocab_size=49408,
                    transformer_width=768, transformer_heads=12, transformer_layers=12),
    "RN50x64": dict(embed_dim=1024, vision_layers=(3, 15, 36, 10), vision_width=128,
                    vision_patch_size=0, context_length=77, vocab_size=49408,
                    transformer_width=1024, transformer_heads=16, transformer_layers=12),
    "ViT-B/32": dict(embed_dim=512, vision_layers=12, vision_width=768,
                     vision_patch_size=32, context_length=77, vocab_size=49408,
                     transformer_width=512, transformer_heads=8, transformer_layers=12),
    "ViT-B/16": dict(embed_dim=512, vision_layers=12, vision_width=768,
                     vision_patch_size=16, context_length=77, vocab_size=49408,
                     transformer_width=512, transformer_heads=8, transformer_layers=12),
    "ViT-L/14": dict(embed_dim=768, vision_layers=24, vision_width=1024,
                     vision_patch_size=14, context_length=77, vocab_size=49408,
                     transformer_width=768, transformer_heads=12, transformer_layers=12),
    "ViT-L/14@336px": dict(embed_dim=768, vision_layers=24, vision_width=1024,
                           vision_patch_size=14, context_length=77, vocab_size=49408,
                           transformer_width=768, transformer_heads=12,
                           transformer_layers=12),
}
# the image side a backbone is built for where it is not 224 (JAX sizes the
# position embeddings from the first image it sees; here they are built)
CLIP_IMAGE_SIZE = {"ViT-L/14@336px": 336}
