"""Import torch/torchvision checkpoints into the port's variable trees.

A copy of ``quantize_tpu/models/import_torch.py`` (numpy only, so both
packages fold and lay out the same weights bit for bit). The trees are the
port's variables under their flax names (:func:`quantize_tpu_torch.convert.to_numpy`),
and the result loads back into the model's modules. Conversion includes the
BN-folding transform the reference performs during surgery
(``modelzoo/modules/quantconv2d.py:115-133``):

* bias  ← bn_bias + (conv_bias − running_mean) · γ / √(var + eps)
* weight← W · γ/√(var+eps)   (per out-channel), or, with ``into_scale``,
  the multiplier is returned separately to install as the weight-quantizer
  ``static_scale`` instead of touching the weight data.

Layout changes: conv OIHW → HWIO, linear (out, in) → (in, out).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np


def _np(t: Any) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def conv_torch_to_hwio(w: Any) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def linear_torch_to_io(w: Any) -> np.ndarray:
    return _np(w).T  # (out, in) -> (in, out)


def fold_bn(
    conv_w_oihw: Any,
    conv_b: Optional[Any],
    bn_gamma: Any,
    bn_beta: Any,
    running_mean: Any,
    running_var: Any,
    eps: float = 1e-5,
    into_scale: bool = False,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Fold a BatchNorm into the preceding conv.

    Returns (weight_oihw, bias, static_scale) — ``static_scale`` is None
    unless ``into_scale``, in which case the weight is left unscaled and the
    multiplier is returned for the quantizer.
    """
    w = _np(conv_w_oihw)
    gamma, beta = _np(bn_gamma), _np(bn_beta)
    mean, var = _np(running_mean), _np(running_var)
    b = _np(conv_b) if conv_b is not None else np.zeros(w.shape[0], np.float32)

    mult = gamma / np.sqrt(var + eps)
    bias = beta + (b - mean) * mult
    if into_scale:
        return w, bias, mult
    return w * mult.reshape(-1, 1, 1, 1), bias, None


class StateDict:
    """Thin cursor over a torch state_dict with key-prefix navigation."""

    def __init__(self, sd: Mapping[str, Any], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix

    def sub(self, name: str) -> "StateDict":
        p = f"{self.prefix}{name}."
        return StateDict(self.sd, p)

    def __getitem__(self, key: str) -> Any:
        return self.sd[self.prefix + key]

    def get(self, key: str, default=None) -> Any:
        return self.sd.get(self.prefix + key, default)

    def __contains__(self, key: str) -> bool:
        return (self.prefix + key) in self.sd


def import_conv_bn(
    sd: StateDict,
    conv_key: str,
    bn_key: Optional[str],
    fold: bool,
    into_scale: bool = False,
) -> Dict[str, Any]:
    """Produce the param dict (and optional quantizer static_scale) for one
    QuantConv site from torch ``conv_key``/``bn_key`` entries.

    Returns a dict with 'kernel' (HWIO), optional 'bias', and optional
    '_static_scale' (caller installs into qparams) / '_bn' (unfolded BN
    params for a separate BatchNorm module).
    """
    w = sd[f"{conv_key}.weight"]
    b = sd.get(f"{conv_key}.bias")
    out: Dict[str, Any] = {}
    if bn_key is not None and fold:
        w_f, bias, ss = fold_bn(
            w, b,
            sd[f"{bn_key}.weight"], sd[f"{bn_key}.bias"],
            sd[f"{bn_key}.running_mean"], sd[f"{bn_key}.running_var"],
            into_scale=into_scale,
        )
        out["kernel"] = w_f.transpose(2, 3, 1, 0)
        out["bias"] = bias
        if ss is not None:
            out["_static_scale"] = ss
    else:
        out["kernel"] = conv_torch_to_hwio(w)
        if b is not None:
            out["bias"] = _np(b)
        if bn_key is not None:
            out["_bn"] = {
                "scale": _np(sd[f"{bn_key}.weight"]),
                "bias": _np(sd[f"{bn_key}.bias"]),
                "mean": _np(sd[f"{bn_key}.running_mean"]),
                "var": _np(sd[f"{bn_key}.running_var"]),
            }
    return out


def get_node(tree: Dict[str, Any], path: str) -> Dict[str, Any]:
    """Walk ``tree`` along slash-separated ``path``, raising on a missing
    segment.

    Importers must never *create* parameter nodes — a path that does not
    exist in the initialized variables tree means the importer and the model
    naming have drifted, and silently inserting an orphan subtree would leave
    the model on its random init (exactly the failure mode this guards
    against)."""
    node = tree
    walked = []
    for part in path.split("/"):
        walked.append(part)
        if not isinstance(node, dict) or part not in node:
            have = sorted(node.keys()) if isinstance(node, dict) else type(node)
            raise KeyError(
                f"importer path {'/'.join(walked)!r} not in variables tree "
                f"(available at that level: {have})")
        node = node[part]
    return node


def set_leaf(tree: Dict[str, Any], path: str, value: Any,
             allow_new: bool = False) -> None:
    """Assign ``tree[path] = value`` where the parent node (and, unless
    ``allow_new``, the leaf key) must already exist.

    ``allow_new`` also creates missing intermediate nodes — reserved for
    variables that legitimately may not exist before calibration (e.g. the
    weight-quantizer ``static_scale``); parameters must always resolve."""
    parent_path, _, leaf = path.rpartition("/")
    if allow_new and parent_path:
        node = tree
        for part in parent_path.split("/"):
            node = node.setdefault(part, {})
    else:
        node = get_node(tree, parent_path) if parent_path else tree
    if not allow_new and leaf not in node:
        raise KeyError(
            f"importer leaf {path!r} not in variables tree "
            f"(available: {sorted(node.keys())})")
    existing = node.get(leaf)
    if existing is not None and hasattr(existing, "shape"):
        if tuple(existing.shape) != tuple(np.shape(value)):
            raise ValueError(
                f"importer leaf {path!r}: shape mismatch "
                f"{tuple(np.shape(value))} vs model {tuple(existing.shape)}")
    node[leaf] = value


def import_linear(sd: StateDict, key: str) -> Dict[str, Any]:
    out = {"kernel": linear_torch_to_io(sd[f"{key}.weight"])}
    b = sd.get(f"{key}.bias")
    if b is not None:
        out["bias"] = _np(b)
    return out


def put_conv_bn(
    trees: Dict[str, Dict[str, Any]],
    sd: StateDict,
    our_conv: str,
    our_bn: Optional[str],
    conv_key: str,
    bn_key: Optional[str],
    fold: bool,
    into_scale: bool = False,
) -> None:
    """Place one torch conv(+BN) pair into the variables trees at explicit
    destination paths (strict: every destination must already exist).

    ``trees`` holds mutable copies keyed ``params`` / ``batch_stats`` /
    ``qparams``. ``our_bn`` is the path of the (flax) ``_BN`` wrapper module,
    used only when ``fold`` is off."""
    out = import_conv_bn(sd, conv_key, bn_key, fold, into_scale)
    set_leaf(trees["params"], f"{our_conv}/kernel", out["kernel"])
    if "bias" in out:
        set_leaf(trees["params"], f"{our_conv}/bias", out["bias"])
    if "_static_scale" in out:
        set_leaf(trees["qparams"], f"{our_conv}/w_quantizer/static_scale",
                 out["_static_scale"], allow_new=True)
    if "_bn" in out:
        assert our_bn is not None, f"{our_conv}: BN present but no our_bn path"
        bn = out["_bn"]
        node = get_node(trees["params"], f"{our_bn}/BatchNorm_0")
        node["scale"], node["bias"] = bn["scale"], bn["bias"]
        stats = get_node(trees["batch_stats"], f"{our_bn}/BatchNorm_0")
        stats["mean"], stats["var"] = bn["mean"], bn["var"]


def put_bn(trees: Dict[str, Dict[str, Any]], sd: StateDict,
           our_bn: str, bn_key: str) -> None:
    """Place a standalone (non-folded) BatchNorm into a flax ``_BN`` site."""
    node = get_node(trees["params"], f"{our_bn}/BatchNorm_0")
    node["scale"] = _np(sd[f"{bn_key}.weight"])
    node["bias"] = _np(sd[f"{bn_key}.bias"])
    stats = get_node(trees["batch_stats"], f"{our_bn}/BatchNorm_0")
    stats["mean"] = _np(sd[f"{bn_key}.running_mean"])
    stats["var"] = _np(sd[f"{bn_key}.running_var"])


def put_linear(trees: Dict[str, Dict[str, Any]], sd: StateDict,
               our: str, key: str) -> None:
    lin = import_linear(sd, key)
    set_leaf(trees["params"], f"{our}/kernel", lin["kernel"])
    if "bias" in lin:
        set_leaf(trees["params"], f"{our}/bias", lin["bias"])


def copy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    return tree


def make_trees(variables: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Mutable copies of the collections importers write into."""
    return {
        "params": copy_tree(variables["params"]),
        "batch_stats": copy_tree(variables.get("batch_stats", {})),
        "qparams": copy_tree(variables.get("qparams", {})),
    }


def finish_trees(variables: Dict[str, Any],
                 trees: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    out_vars = dict(variables)
    out_vars["params"] = trees["params"]
    if trees["batch_stats"]:
        out_vars["batch_stats"] = trees["batch_stats"]
    if trees["qparams"]:
        out_vars["qparams"] = trees["qparams"]
    return out_vars
