"""Packed-model export: the pack pass and the deploy variables.

PyTorch counterpart of ``quantize_tpu/deploy.py``. :func:`pack_model` runs
the model once in ``mode='pack'``, which writes every layer's integer
weights, baked biases and activation qparams into the ``packed``
collection (buffers of the model's modules), and returns the deploy
variables under their flax names, like the JAX package's deploy pytree:
``packed``, ``params`` without the float kernel and bias of packed layers,
and the other collections except observer state. :func:`unpack_model`
inverts it.

On a model loaded onto a mesh (:mod:`~quantize_tpu_torch.parallel`) each
rank packs with its own rows; the layers on a slice of their out channels
write their slices, and :func:`pack_model` returns this rank's deploy
variables, whose ``parallel.gather_variables`` equals the one-device pack
of the gathered calibrated variables.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import convert

_W_KEYS = ("w_int", "w_p4", "w_p4c")


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, dict):
        x = x["img"]
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32).to(device)


def pack_model(model: torch.nn.Module, sample_x, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Run the pack pass on ``device`` and return the deploy variables
    ``{collection: {"path/leaf": tensor}}``: on a model-sharded mesh this
    rank's, as :class:`~quantize_tpu_torch.parallel.ShardedVariables` (the
    leaves of its split layers are slices)."""
    from .parallel.mesh import ShardedVariables
    from .parallel.tensor_parallel import rank_variables

    device = torch.device(device)
    model.to(device)
    with torch.no_grad():
        model(_to_device(sample_x, device), mode="pack")
    cols = rank_variables(model)
    packed = cols.get("packed", {})
    # a packed layer's float kernel and bias go, as in JAX's deploy pytree;
    # a model that is one layer (its variables at the root) keeps them
    packed_layers = {k.rsplit("/", 1)[0] for k in packed
                     if "/" in k and k.rsplit("/", 1)[1] in _W_KEYS}
    params = {k: v for k, v in cols.get("params", {}).items()
              if not ("/" in k and k.rsplit("/", 1)[0] in packed_layers
                      and k.rsplit("/", 1)[1] in ("kernel", "bias"))}
    deploy = {"packed": packed, "params": params}
    for col, val in cols.items():
        if col not in ("params", "packed", "qobs"):
            deploy[col] = val
    spec = getattr(cols, "spec", None)
    if spec is None:
        return deploy
    return ShardedVariables(deploy, cols.mesh,
                            {col: {k: spec[col][k] for k in flat} for col, flat in deploy.items()})


def unpack_model(deploy: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Inverse transform (JAX ``deploy.unpack_model``): deploy variables ->
    simulation-style variables ``{"params", "qparams", "batch_stats"}``,
    each ``{"path/leaf": tensor}``.

    Every packed integer weight (``w_int``; ``w_p4`` split-half int4;
    ``w_p4c`` int4 pairs) becomes a float32 kernel ``(w + z)·s`` beside its
    baked bias, so a packed checkpoint can go back to fake-quant evaluation
    or fine-tuning: load the result with
    :func:`quantize_tpu_torch.convert.from_jax_variables`. ``deploy`` is the
    port's layout or JAX's nested one (tensors or numpy arrays)."""
    from .ops.qmatmul import unpack_int4_splithalf
    from .quant.pack import unpack_int4_pairs

    def flat(col):
        return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
                for k, v in convert.flatten(deploy.get(col, {})).items()}

    packed = flat("packed")
    params = flat("params")
    layers = {k.rsplit("/", 1)[0] for k in packed
              if "/" in k and k.rsplit("/", 1)[1] in _W_KEYS}
    for path in sorted(layers):
        leaf = {name: packed.get(f"{path}/{name}") for name in (*_W_KEYS, "w_scale", "w_zero")}
        if leaf["w_p4"] is not None:
            w_int = unpack_int4_splithalf(leaf["w_p4"])
        elif leaf["w_p4c"] is not None:
            w_int = unpack_int4_pairs(leaf["w_p4c"], axis=2)
        else:
            w_int = leaf["w_int"]
        params[f"{path}/kernel"] = (w_int.float() + leaf["w_zero"]) * leaf["w_scale"]
        params[f"{path}/bias"] = packed[f"{path}/bias"]
    out = {"params": params}
    for col in ("qparams", "batch_stats"):
        if col in deploy:
            out[col] = flat(col)
    return out


def model_size_bytes(variables: Dict[str, Any]) -> int:
    """Total bytes of all tensor leaves of a (nested) variables dict."""
    total = 0
    stack = [variables]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += int(node.numel() * node.element_size()) if isinstance(node, torch.Tensor) \
                else int(np.asarray(node).nbytes)
    return total
