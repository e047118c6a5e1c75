"""Regex-scoped per-layer quantization config resolution (PyTorch port of
``quantize_tpu/nn/intercept.py``; pure Python, copied).

The reference resolves each layer's quant parameters by matching config keys
against the module path during surgery (``modelzoo/reconstruct.py:44-91``):
start from ``quant.default``, then merge any key of ``quant`` that
``re.match``-es the layer-kind name (``nn_conv2d``, ``nn_linear``,
``nn_conv2d_bn2d``, ``nn_multiheadattention``) or the slash-joined module
path (``/layer1/0/conv1``). Here the same semantics run at model
*construction* time: models ask a :class:`QuantCtx` for the
:class:`LayerQuantCfg` at each site — no surgery needed.
"""
from __future__ import annotations

import re
from typing import Any, Mapping, Optional, Sequence, Union

from ..utils.config import Config, dict_merge
from .layers import FP32, LayerQuantCfg

_LAYER_FIELDS = ("weight", "activation", "bias_correct", "bn_folding", "adaround")


class QuantCtx:
    """Resolves layer-site quant configs from a ``cfg.quant``-style mapping.

    Args:
        cfg_quant: mapping with a ``default`` entry plus optional scoped
            overrides keyed by layer-kind names or path regexes.
        enabled: False produces FP32 layers everywhere (handy for building
            the reference FP32 baseline from the same model code).
    """

    def __init__(self, cfg_quant: Union[Mapping, Config, None], enabled: bool = True):
        if isinstance(cfg_quant, Config):
            cfg_quant = cfg_quant.to_dict()
        self.cfg: dict = dict(cfg_quant or {})
        self.enabled = enabled and bool(self.cfg)

    @property
    def default(self) -> dict:
        d = self.cfg.get("default") or {}
        return d if isinstance(d, dict) else {}

    @property
    def bn_folding_enabled(self) -> bool:
        return bool(self.default.get("bn_folding"))

    def _overrides_for(self, name: str) -> dict:
        """Merge all non-default keys whose regex matches ``name``."""
        merged: dict = {}
        for k, v in self.cfg.items():
            if k == "default" or not isinstance(v, dict):
                continue
            if re.match(k, name):
                merged = dict_merge(merged, v)
        return merged

    def act_layer_enabled(self, kind: str) -> bool:
        """Activation-quantized ReLU/pool sites are *opt-in*: the reference
        left their surgery commented out (``reconstruct.py:123-129``), so a
        model creates one only when the config carries a matching kind key
        (``nn_relu`` / ``nn_maxpool2d`` / ``nn_adaptiveavgpool2d``)."""
        return self.enabled and isinstance(self.cfg.get(kind), dict)

    def resolve(self, path: str, kind: str, kinds: Optional[Sequence[str]] = None) -> LayerQuantCfg:
        """Resolve the quant config for a layer.

        Args:
            path: slash-joined module path, e.g. ``/layer1/0/conv1``.
            kind: primary kind key (``nn_conv2d``, ``nn_linear``,
                ``nn_conv2d_bn2d``, ``nn_multiheadattention``, ``nn_relu``,
                ``nn_maxpool2d``, ``nn_adaptiveavgpool2d``).
            kinds: extra kind keys to try (merged in order before the path).
        """
        if not self.enabled:
            return FP32
        params = dict(self.default)
        for name in [*(kinds or []), kind, path]:
            params = dict_merge(params, self._overrides_for(name))
        return self._to_layer_cfg(params)

    @staticmethod
    def _to_layer_cfg(params: Mapping[str, Any]) -> LayerQuantCfg:
        known = {k: params.get(k) for k in _LAYER_FIELDS if params.get(k) is not None}
        weight = dict(known.get("weight") or {})
        activation = dict(known.get("activation") or {})
        # the runner-level `adaround` block attaches to the weight quantizer
        if known.get("adaround"):
            ar = known["adaround"]
            weight["adaround"] = dict(ar) if isinstance(ar, Mapping) else {}
        return LayerQuantCfg(
            weight=weight,
            activation=activation,
            bias_correct=known.get("bias_correct"),
            bn_folding=known.get("bn_folding"),
        )

    # Convenience: a disabled context (pure FP32 model)
    @classmethod
    def fp32(cls) -> "QuantCtx":
        return cls(None, enabled=False)
