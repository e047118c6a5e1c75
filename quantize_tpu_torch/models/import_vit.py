"""Torchvision ViT state_dict -> the port's variable trees.

A copy of ``quantize_tpu/models/import_vit.py`` (numpy only). Maps
torchvision ``vit_b_16``-style checkpoints onto
:class:`quantize_tpu_torch.models.vit.VisionTransformer`: the fused
``in_proj_weight`` is chunked into q/k/v projections (the reference handles
both fused and separate layouts, ``quantmultiheadattention.py:97-104``),
linears transpose (out,in)->(in,out), and the patch conv goes OIHW->HWIO.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .import_torch import StateDict, _np, conv_torch_to_hwio, linear_torch_to_io


def _ln(sd: StateDict, key: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _linear(sd: StateDict, key: str) -> Dict[str, np.ndarray]:
    out = {"kernel": linear_torch_to_io(sd[f"{key}.weight"])}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _mha(sd: StateDict, key: str) -> Dict[str, Any]:
    """torch nn.MultiheadAttention params -> q/k/v/out QuantDense trees."""
    if f"{key}.in_proj_weight" in sd:
        w = _np(sd[f"{key}.in_proj_weight"])  # (3D, D)
        b = _np(sd[f"{key}.in_proj_bias"]) if f"{key}.in_proj_bias" in sd else None
        d = w.shape[1]
        wq, wk, wv = w[:d], w[d:2 * d], w[2 * d:]
        bq, bk, bv = (b[:d], b[d:2 * d], b[2 * d:]) if b is not None else (None,) * 3
    else:
        wq = _np(sd[f"{key}.q_proj_weight"])
        wk = _np(sd[f"{key}.k_proj_weight"])
        wv = _np(sd[f"{key}.v_proj_weight"])
        bq = bk = bv = None

    def proj(w_, b_):
        out = {"kernel": w_.T}
        if b_ is not None:
            out["bias"] = b_
        return out

    return {
        "q_proj": proj(wq, bq),
        "k_proj": proj(wk, bk),
        "v_proj": proj(wv, bv),
        "out_proj": _linear(sd, f"{key}.out_proj"),
    }


def import_vit(state_dict, variables: Dict[str, Any], num_layers: int = 12) -> Dict[str, Any]:
    """Fill a VisionTransformer variables tree from torchvision weights."""
    sd = StateDict(state_dict)
    params = _deepcopy(variables["params"])

    conv = {"kernel": conv_torch_to_hwio(sd["conv_proj.weight"])}
    if "conv_proj.bias" in sd:
        conv["bias"] = _np(sd["conv_proj.bias"])
    params["conv_proj"].update(conv)

    params["class_token"] = _np(sd["class_token"]).reshape(params["class_token"].shape)
    params["pos_embedding"] = _np(sd["encoder.pos_embedding"]).reshape(
        params["pos_embedding"].shape
    )

    for i in range(num_layers):
        t = f"encoder.layers.encoder_layer_{i}"
        node = params[f"encoder_layer_{i}"]
        node["ln_1"].update(_ln(sd, f"{t}.ln_1"))
        node["ln_2"].update(_ln(sd, f"{t}.ln_2"))
        mha = _mha(sd, f"{t}.self_attention")
        for k, v in mha.items():
            node["self_attention"][k].update(v)
        node["mlp"]["linear1"].update(_linear(sd, f"{t}.mlp.0"))
        node["mlp"]["linear2"].update(_linear(sd, f"{t}.mlp.3"))

    params["ln"].update(_ln(sd, "encoder.ln"))
    params["head"].update(_linear(sd, "heads.head"))

    out = dict(variables)
    out["params"] = params
    return out


def _deepcopy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _deepcopy(v) for k, v in tree.items()}
    return tree
