"""CoOp / CoCoOp prompt learning over the quantized CLIP towers.

PyTorch counterpart of ``quantize_tpu/models/clip/prompt_learning.py``:
learnable context embeddings replace the hand-written prompt templates.

* **CoOp**: ``n_ctx`` learnable context vectors (optionally class-specific,
  ``csc``) take the slots after SOT of each class-name prompt; the text
  features come from the (optionally quantized) text transformer.
* **CoCoOp**: a small float meta-net (``meta_fc1``, ReLU, ``meta_fc2``) maps
  each image's features to a shift of the context vectors.

The text tower runs on embeddings directly (the token lookup is bypassed)
with the additive causal mask. The context vectors (``params/ctx``) and the
meta-net are ``nn.Parameter``s that autograd reaches; training them waits
for the QAT and AdaRound runners.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...nn.intercept import QuantCtx
from ...nn.layers import lecun_normal_
from ...nn.variables import VarModule
from . import clip_config
from .model import CLIP, CLIP_IMAGE_SIZE, causal_mask, l2_normalize, scaled
from .tokenizer import HashTokenizer, get_default_tokenizer, tokenize


def _encode_from_embeddings(clip: CLIP, emb: torch.Tensor, eot_idx: torch.Tensor,
                            mode: str = "fp32") -> torch.Tensor:
    """Text features from pre-built token embeddings (N, L, D)."""
    x = emb + clip.get_var("params", "positional_embedding")[: emb.shape[1]]
    x = clip.transformer(x, mode=mode, mask=causal_mask(x.shape[1], device=x.device))
    x = clip.ln_final(x)
    x = x[torch.arange(x.shape[0], device=x.device), eot_idx]
    return x @ clip.get_var("params", "text_projection")


class Dense(VarModule):
    """flax ``nn.Dense``: ``x @ kernel + bias``, kernel (in, out)."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.put_var("params", "kernel", torch.zeros((in_features, features), **f32))
        self.put_var("params", "bias", torch.zeros((features,), **f32))

    def init_params(self, generator: torch.Generator) -> None:
        kernel = self.get_var("params", "kernel")
        lecun_normal_(kernel, kernel.shape[0], generator)
        with torch.no_grad():
            self.get_var("params", "bias").zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.get_var("params", "kernel") + self.get_var("params", "bias")


class CoOpCLIP(VarModule):
    """CLIP with learned prompt context (CoOp)."""

    def __init__(self, backbone: str, num_classes: int, n_ctx: int = 16, csc: bool = False,
                 ctx: Optional[QuantCtx] = None, config_overrides: Optional[dict] = None,
                 classnames: Optional[Sequence[str]] = None, image_size: Optional[int] = None,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        cfg = clip_config(backbone, config_overrides)
        self.cfg, self.num_classes, self.n_ctx = cfg, num_classes, n_ctx
        self.clip = CLIP(**cfg, image_size=image_size or CLIP_IMAGE_SIZE.get(backbone, 224),
                         ctx=ctx or QuantCtx.fp32(), device=device)
        dim = cfg["transformer_width"]
        shape = (num_classes, n_ctx, dim) if csc else (n_ctx, dim)
        self.put_var("params", "ctx", torch.zeros(shape, dtype=torch.float32, device=device))
        # the class-name token grids: "X ... X <classname>." per class
        names = list(classnames or [str(i) for i in range(num_classes)])
        prefix = " ".join(["X"] * n_ctx)
        tok = get_default_tokenizer()
        if tok.vocab_size > cfg["vocab_size"]:
            tok = HashTokenizer(cfg["vocab_size"])
        toks = tokenize([f"{prefix} {n.replace('_', ' ')}." for n in names], tokenizer=tok,
                        context_length=cfg["context_length"])
        self.register_buffer("tokens", torch.from_numpy(toks).long().to(device), persistent=False)

    def init_params(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if hasattr(mod, "init_params") and mod is not self:
                mod.init_params(generator)
        ctx = self.get_var("params", "ctx")
        with torch.no_grad():
            ctx.copy_(torch.randn(ctx.shape, generator=generator) * 0.02)

    def _prompt_embeddings(self, extra_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n_cls, L, dim) embeddings with slots 1..n_ctx replaced by the
        learned context."""
        emb = self.clip.token_embedding(self.tokens)
        ctx = self.get_var("params", "ctx")
        if ctx.dim() == 2:
            ctx = ctx.unsqueeze(0).expand(self.num_classes, *ctx.shape)
        if extra_shift is not None:
            ctx = ctx + extra_shift[None, None, :]
        return torch.cat([emb[:, :1], ctx, emb[:, 1 + self.n_ctx:]], dim=1)

    def text_features(self, mode: str = "fp32",
                      extra_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self._prompt_embeddings(extra_shift)
        feats = _encode_from_embeddings(self.clip, emb, self.tokens.argmax(dim=-1), mode=mode)
        return l2_normalize(feats)

    def _scaled(self, img: torch.Tensor) -> torch.Tensor:
        return scaled(self.clip.get_var("params", "logit_scale"), img)

    def forward(self, images: torch.Tensor, mode: str = "fp32",
                train: bool = False) -> torch.Tensor:
        del train  # as JAX's: the image tower runs on its running statistics
        img = l2_normalize(self.clip.encode_image(images, mode=mode))
        return self._scaled(img) @ self.text_features(mode=mode).T


class CoCoOpCLIP(CoOpCLIP):
    """CoOp plus instance-conditioned context through a meta-net (CoCoOp)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        device = self.get_var("params", "ctx").device
        vis_dim, dim = self.cfg["embed_dim"], self.cfg["transformer_width"]
        self.meta_fc1 = Dense(vis_dim, vis_dim // 16, device)
        self.meta_fc2 = Dense(vis_dim // 16, dim, device)

    def forward(self, images: torch.Tensor, mode: str = "fp32",
                train: bool = False) -> torch.Tensor:
        del train  # as JAX's: the image tower runs on its running statistics
        img = l2_normalize(self.clip.encode_image(images, mode=mode))
        shifts = self.meta_fc2(torch.relu(self.meta_fc1(img)))  # (batch, dim)
        return torch.stack([self._scaled(feat) @ self.text_features(mode, shift).T
                            for feat, shift in zip(img, shifts)])


__all__ = ["CoOpCLIP", "CoCoOpCLIP", "Dense"]
