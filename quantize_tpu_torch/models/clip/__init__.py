"""CLIP zero-shot classification wrapper and zoo registration.

PyTorch counterpart of ``quantize_tpu/models/clip/__init__.py`` (the
reference ``CLIPModel``): the class-prompt text embeddings are computed
once through the text tower (normalized, averaged over the templates,
normalized again) into the ``zeroshot/weights`` variable, and
classification is ``exp(logit_scale) * image_features @ zeroshot_weights``.

The text tower is quantization-aware too: :meth:`CLIPZeroShot.precompute`
runs it in any mode. The model's state lives in its modules, so
``precompute(tokens, mode="calibrate")`` calibrates the text layers,
``mode="pack"`` packs them and ``mode="packed"`` runs them on the int8
kernels (causal attention on kernel K8), as the JAX package's
``model.apply(..., method=CLIPZeroShot.precompute, mutable=[...])`` does.
:func:`~quantize_tpu_torch.deploy.pack_model` packs the image tower only
(its pass runs :meth:`CLIPZeroShot.forward`), and carries the ``zeroshot``
collection into the deploy variables.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...nn.intercept import QuantCtx
from ...nn.variables import VarModule, collections
from .model import CLIP, CLIP_CONFIGS, CLIP_IMAGE_SIZE, l2_normalize, scaled
from .tokenizer import (CONTEXT_LENGTH, BPETokenizer, HashTokenizer, get_default_tokenizer,
                        tokenize)

DEFAULT_PROMPTS = ["a photo of a {}."]


def clip_config(backbone: str, config_overrides: Optional[dict] = None) -> dict:
    cfg = dict(CLIP_CONFIGS[backbone])
    cfg.update(config_overrides or {})
    return cfg


class CLIPZeroShot(VarModule):
    def __init__(self, backbone: str, num_classes: int, ctx: Optional[QuantCtx] = None,
                 config_overrides: Optional[dict] = None, image_size: Optional[int] = None,
                 device="cuda"):
        super().__init__()
        device = torch.device(device)
        self.backbone, self.num_classes = backbone, num_classes
        self.config_overrides = dict(config_overrides or {})
        cfg = clip_config(backbone, self.config_overrides)
        self.context_length = cfg["context_length"]
        size = image_size or CLIP_IMAGE_SIZE.get(backbone, 224)
        self.clip = CLIP(**cfg, image_size=size, ctx=ctx or QuantCtx.fp32(), device=device)
        self.put_var("zeroshot", "weights",
                     torch.zeros((cfg["embed_dim"], num_classes), dtype=torch.float32,
                                 device=device))

    def init_params(self, generator: torch.Generator) -> None:
        self.clip.init_params(generator)

    def forward(self, images: torch.Tensor, mode: str = "fp32") -> torch.Tensor:
        img = l2_normalize(self.clip.encode_image(images, mode=mode))
        return scaled(self.clip.get_var("params", "logit_scale"), img) @ self.get_var(
            "zeroshot", "weights")

    def precompute(self, tokens, mode: str = "fp32") -> torch.Tensor:
        """Compute and store the zero-shot weights from ``tokens``
        ``(num_classes, n_templates, context_length)`` int, through the text
        tower in ``mode``; returns the class embeddings (num_classes, D)."""
        weights = self.get_var("zeroshot", "weights")
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(tokens, torch.Tensor)
                                 else tokens).to(weights.device)
        c, t, length = tokens.shape
        with torch.no_grad():
            emb = l2_normalize(self.clip.encode_text(tokens.reshape(c * t, length), mode=mode))
            count = torch.tensor(float(t), dtype=torch.float32, device=emb.device)
            emb = l2_normalize(emb.reshape(c, t, -1).sum(dim=1) / count)
        self.put_var("zeroshot", "weights", emb.T.contiguous().float())
        return emb


def class_prompt_tokens(classnames: Sequence[str], prompts: Optional[Sequence[str]] = None,
                        tokenizer=None, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """(num_classes, n_templates, context_length) int32 token grid."""
    prompts = list(prompts) if prompts else list(DEFAULT_PROMPTS)
    texts = [p.format(c) for c in classnames for p in prompts]
    toks = tokenize(texts, tokenizer=tokenizer, context_length=context_length)
    return toks.reshape(len(classnames), len(prompts), context_length)


def build_zeroshot(model: CLIPZeroShot, classnames, prompts=None, tokenizer=None,
                   mode: str = "fp32"):
    """Precompute the zero-shot weights in place (the text tower in
    ``mode``) and return the model's variables."""
    toks = class_prompt_tokens(classnames, prompts, tokenizer, model.context_length)
    model.precompute(toks, mode=mode)
    return collections(model)


def _make_clip(backbone: str):
    def ctor(num_classes: int = 1000, ctx: Optional[QuantCtx] = None, device="cuda",
             **kw) -> CLIPZeroShot:
        return CLIPZeroShot(backbone=backbone, num_classes=num_classes, ctx=ctx, device=device,
                            **kw)

    return ctor


CLIP_MODELS = {
    "clip_rn50": _make_clip("RN50"),
    "clip_rn101": _make_clip("RN101"),
    "clip_rn50x4": _make_clip("RN50x4"),
    "clip_rn50x16": _make_clip("RN50x16"),
    "clip_rn50x64": _make_clip("RN50x64"),
    "clip_vit-b32": _make_clip("ViT-B/32"),
    "clip_vit-b16": _make_clip("ViT-B/16"),
    "clip_vit-l14": _make_clip("ViT-L/14"),
    "clip_vit-l14@336px": _make_clip("ViT-L/14@336px"),
}

__all__ = [
    "CLIP", "CLIPZeroShot", "CLIP_CONFIGS", "CLIP_MODELS",
    "BPETokenizer", "HashTokenizer", "get_default_tokenizer", "tokenize",
    "class_prompt_tokens", "build_zeroshot", "DEFAULT_PROMPTS",
]
