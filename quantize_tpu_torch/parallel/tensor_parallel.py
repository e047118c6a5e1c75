"""Tensor-parallel packed inference across the ranks of a mesh.

A :class:`~quantize_tpu_torch.nn.layers.QuantConv` or
:class:`~quantize_tpu_torch.nn.layers.QuantDense` whose variables were
sharded (:func:`~.mesh.shard_variables`, then
:func:`~quantize_tpu_torch.convert.from_jax_variables`) holds, on each rank,
its slice ``[lo, hi)`` of the out channels: of ``w_int`` (and so of the
kernels' own copies, which ``put_var`` makes from the slice: ``w_kmajor``,
``w_colsum``, the stem's ``w_s2d``), ``w_scale``, ``w_zero``, ``col_sum``,
``bias`` and the zero-point correction map ``corr_a``. Its packed forward
runs the same kernel as on one device (K1, K2, K3, KQ) on the whole input and
its slice, K2 with its residual cut to the same channels, then gathers the
output along channels over the ``model`` group (:func:`all_gather`). Every
output channel is a function of the whole input and its own weights (int32
sums, then a per-channel epilogue), so the gathered output equals the
one-device forward bit for bit. The activation quantize is per tensor on the
whole input and needs nothing more.

A layer whose out-channel split is not a per-channel function runs whole:
grouped and depthwise convs (K3g, the float depthwise path), the
projections of an attention block (K8/K9 read the fused q/k/v), and dense
layers holding split-half int4 weights (K4's ``w_p4``). Its sharded leaves,
like those of every other module (norms, embeddings, observers), are
gathered back whole when the variables are loaded, and each gather counts as
a collective (:class:`~.scaling.CollectiveCounter`).

The collectives run over gloo. A CUDA tensor is staged through pinned host
memory explicitly (the copies are counted in ``staged_bytes``): one code
path on the CPU and the card, and ranks that share a card need no NCCL.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Mapping

import torch
import torch.distributed as dist

from .scaling import record_collective

# per-out-channel leaves that the JAX rules leave whole (the conv's
# zero-point correction map, (1, H', W', co)): a split layer cuts them too
_SPLIT_TOO = {"corr_a"}


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s memory as one uint8 row per leading index (gloo moves any
    dtype as bytes, bit for bit)."""
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Concatenate ``t`` from every rank of ``group``, in rank order, along
    ``dim``, on ``t``'s device. Reports one ``all-gather`` of the result's
    bytes to the active :class:`~.scaling.CollectiveCounter`."""
    world = dist.get_world_size(group)
    dim = dim % t.dim()
    src = t.contiguous()
    cuda = src.is_cuda
    timing = None
    if cuda:
        timing = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        timing[0].record()
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)  # waits for the work that makes ``t``
    else:
        host, t0 = src, time.perf_counter()
    full = torch.empty((world, *src.shape), dtype=src.dtype, pin_memory=cuda)
    dist.all_gather(list(_as_bytes(full).unbind(0)), _as_bytes(host[None])[0], group=group)
    if cuda:
        full = full.to(src.device, non_blocking=True)
    shape = src.shape
    out = full.movedim(0, dim).reshape(*shape[:dim], world * shape[dim], *shape[dim + 1:])
    if cuda:
        timing[1].record()
        record_collective("all-gather", out.nbytes, src.nbytes + out.nbytes, events=timing)
    else:
        record_collective("all-gather", out.nbytes, 0, seconds=time.perf_counter() - t0)
    return out


class TPShard:
    """A layer's slice ``[lo, hi)`` of its ``n_out`` out channels on this
    rank, and the forward that gathers the slices."""

    def __init__(self, mesh, n_out: int):
        tp = mesh.shape["model"]
        j = mesh.coords[1]
        self.group = mesh.groups["model"]
        self.lo, self.hi = j * n_out // tp, (j + 1) * n_out // tp

    def run(self, local: Callable, x: torch.Tensor, residual=None, **kw) -> Any:
        """``local`` (the layer's packed forward on its slice) on the whole
        ``x`` and the residual's channels of the slice, then the output
        gathered along channels; a ``(out, qinput)`` pair keeps its int8
        input, which is whole on every rank."""
        if residual is not None:
            kw["residual"] = residual[..., self.lo:self.hi].contiguous()
        out = local(x, **kw)
        if isinstance(out, tuple):
            return (all_gather(out[0], self.group), *out[1:])
        return all_gather(out, self.group)


def _splits(layer, spec: Mapping[str, Any], in_attention: bool) -> bool:
    """Whether ``layer`` (its leaves' specs ``spec``) runs on its slice of
    the out channels: its weight was split over ``model`` and its forward
    is a per-channel function."""
    from ..nn.layers import QuantConv

    if in_attention or "w_p4" in spec:  # K8/K9 read the fused q/k/v; K4's split-half int4
        return False
    weight = next((spec[k] for k in ("w_int", "w_p4c", "kernel") if k in spec), ())
    return "model" in weight and (not isinstance(layer, QuantConv)
                                  or layer.feature_group_count == 1)


def attach(model: torch.nn.Module, variables: Mapping[str, Any],
           mods: Dict[str, Any]) -> Mapping[str, Any]:
    """Prepare ``variables`` for loading into ``model`` (``mods``: its
    variable modules by path). Every layer they hold leaves of runs whole
    again, unless they are sharded over a ``model`` axis of 2 or more
    (:class:`~.mesh.ShardedVariables`): then each layer that splits gets
    its :class:`TPShard` and its slice of the leaves in ``_SPLIT_TOO``, and
    every other sharded leaf is gathered whole. Returns the variables to
    load."""
    from ..convert import _owner, flatten
    from ..nn.attention import QuantMultiheadAttention

    flat = {col: flatten(tree) for col, tree in variables.items() if col != "taps"}
    owners = {col: {key: _owner(mods, key) for key in leaves} for col, leaves in flat.items()}
    for col in owners.values():
        for owner, _ in col.values():
            if hasattr(owner, "tp_shard"):
                owner.tp_shard = None
    mesh = getattr(variables, "mesh", None)
    if mesh is None or mesh.shape["model"] == 1:
        return variables
    specs = {col: flatten(variables.spec[col]) for col in flat}
    in_attention = {id(m) for a in model.modules() if isinstance(a, QuantMultiheadAttention)
                    for m in a.modules()}
    layer_specs: Dict[int, Dict[str, Any]] = {}  # a module's {leaf: spec}, every collection
    for col, keys in owners.items():
        for key, (owner, leaf) in keys.items():
            layer_specs.setdefault(id(owner), {})[leaf] = specs[col][key]
    for col in owners.values():
        for owner, _ in col.values():
            if (hasattr(owner, "tp_shard") and owner.tp_shard is None
                    and _splits(owner, layer_specs[id(owner)], id(owner) in in_attention)):
                owner.tp_shard = TPShard(mesh, owner.features)
    out: Dict[str, Dict[str, Any]] = {}
    for col, leaves in flat.items():
        out[col] = {}
        for key, value in leaves.items():
            owner, leaf = owners[col][key]
            spec = specs[col][key]
            shard = getattr(owner, "tp_shard", None)
            if shard is not None:
                if leaf in _SPLIT_TOO and "model" not in spec:
                    value = value[..., shard.lo:shard.hi].contiguous()
            elif "model" in spec:
                value = all_gather(value, mesh.groups["model"], dim=spec.index("model"))
            out[col][key] = value
    return out
