"""Tensor parallelism across the ranks of a mesh: packed inference and
training on slices of the out channels.

A :class:`~quantize_tpu_torch.nn.layers.QuantConv` or
:class:`~quantize_tpu_torch.nn.layers.QuantDense` whose variables were
sharded (:func:`~.mesh.shard_variables`, then
:func:`~quantize_tpu_torch.convert.from_jax_variables`) holds, on each rank,
its slice ``[lo, hi)`` of the out channels (:data:`LAYER_SLICES`): the
float ``kernel`` and ``bias``; of the deploy buffers ``w_int`` or ``w_p4c``
(and so the kernels' own copies, which ``put_var`` makes from the slice:
``w_kmajor``, ``w_colsum``, the stem's ``w_s2d``), ``w_scale``, ``w_zero``,
``col_sum``, ``bias`` and the zero-point correction map ``corr_a``; and of
its weight quantizer the per-channel ``scale``/``zero``, a per-channel
``static_scale``, AdaRound's ``V`` (:data:`QUANTIZER_SLICES`) and a
per-channel observer's running statistics (:data:`OBSERVER_SLICES`). With
AWQ's ``q_group_size`` the ``scale``/``zero`` (and the deploy ``w_scale``/
``w_zero``) hold one value per group of an out column's in-features, out
column major: the slice is the groups of its columns. The rules of JAX's
spec leave ``corr_a``, ``static_scale``, ``V`` and the observer state
whole; a split layer cuts them here.

Modes on a slice:

* ``packed``: the same kernel as on one device (K1, K2, K3, KQ) on the whole
  input and the slice, K2 with its residual cut to the same channels, then
  the output gathered along channels over the ``model`` group. Every output
  channel is a function of the whole input and its own weights (int32 sums,
  then a per-channel epilogue), so the gathered output equals the
  one-device forward bit for bit. The activation quantize is per tensor on
  the whole input.
* ``fp32`` and ``quant``: the activation fake quant on the whole input,
  then :func:`identity_sum_grad` (Megatron's *f*), the weight's fake quant
  on the slice with the slice's per-channel qparams, the float conv or
  matmul on the slice plus the bias slice, then :func:`gather_channels`
  (Megatron's *g*), whose backward returns this rank's slice of the
  gradient. The pair sits after the activation fake quant, so the input
  gradient reaching the activation quantizer is the whole one on every
  rank. A weight quantizer's leaves that stay whole (a per-tensor
  ``scale``/``zero``, AWQ's ``awq_scale``) go through
  :func:`identity_sum_grad` too: each rank's gradient of them covers its
  slice only.
* ``calibrate``: the activation observer on the whole input, the weight
  observer on the slice (a per-tensor range, an MSE grid's errors, AWQ's
  losses reduced over ``model``: :mod:`~quantize_tpu_torch.quant.observers`),
  the float forward on the slice, then the output gathered. The qparams and
  observer state come out the same on every rank of the group (its slices
  the same as one device's).
* ``pack``: the slice's deploy buffers (``put_var`` rebuilds the kernels'
  copies from them), then the float output gathered.
* ``init_adaround``: the activation quantizer on the whole input, the
  weight quantizer writing the slice's ``V`` from the slice's kernel and
  per-channel ``scale``/``zero`` (a per-tensor quantizer's whole ones),
  elementwise, so the slice of one device's ``V`` bit for bit; then the
  float output gathered. AdaRound's regularization of a slice takes the
  whole ``V``'s element count
  (:func:`~quantize_tpu_torch.quant.adaround.regularization`).

Loading onto any mesh of two ranks or more also gives every quantizer, and
every layer's bias corrector, the ``data`` group where the mesh has more
than one ``data`` rank: calibration then reduces each observer over the
rows of every rank (JAX calibrates the batch sharded over ``data`` as one
global array). A mesh of one rank, or no mesh, sets no group.

A layer whose out-channel split is not a per-channel function runs whole:
grouped and depthwise convs (K3g, the float depthwise path), the
projections of an attention block (K8/K9 read the fused q/k/v), dense
layers whose weights pack as split-half int4 (K4's ``w_p4``), and a conv
loaded with deploy variables whose packed forward is a float conv (the
weight-only, per-channel-activation and AWQ layouts: on the card the
library's conv over half the out channels sums in another order, so only
K3's int32 sums split bit for bit; with float variables it splits for
training). Its sharded
leaves, like those of every other module (norms, embeddings, observers),
are gathered back whole when the variables are loaded. Every gather and
reduce counts as a collective (:class:`~.scaling.CollectiveCounter`).

The collectives run over gloo. A CUDA tensor is staged through pinned host
memory explicitly (the copies are counted in ``staged_bytes``): one code
path on the CPU and the card, and ranks that share a card need no NCCL.
"""
from __future__ import annotations

import datetime
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from .scaling import record_collective

# a split layer's own leaves held as slices of the out channels (last axis)
LAYER_SLICES = frozenset({"kernel", "bias", "w_int", "w_p4c", "w_scale", "w_zero", "col_sum",
                          "corr_a"})
# its weight quantizer's leaves held as slices where they are one per out
# channel (``V`` is one per weight)
QUANTIZER_SLICES = frozenset({"scale", "zero", "static_scale", "V"})
# its weight quantizer's per-channel observer state (``qobs``), one per out
# channel (AWQ's ``x_mean`` is one per in channel: whole)
OBSERVER_SLICES = frozenset({"state/xmin", "state/xmax", "state/mu_sum", "state/lam_sum"})


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s memory as one uint8 row per leading index (gloo moves any
    dtype as bytes, bit for bit)."""
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def _staged(src: torch.Tensor):
    """``(host copy, timing)``: a CUDA tensor copied to pinned host memory
    with a pair of CUDA events started; a CPU tensor as it is, with the host
    clock's start."""
    if src.is_cuda:
        timing = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        timing[0].record()
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)  # waits for the work that makes ``src``
        return host, timing
    return src, time.perf_counter()


def _record(op: str, out: torch.Tensor, staged: int, timing) -> None:
    if isinstance(timing, tuple):
        timing[1].record()
        record_collective(op, out.nbytes, staged, events=timing)
    else:
        record_collective(op, out.nbytes, 0, seconds=time.perf_counter() - timing)


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Concatenate ``t`` from every rank of ``group``, in rank order, along
    ``dim``, on ``t``'s device. Reports one ``all-gather`` of the result's
    bytes to the active :class:`~.scaling.CollectiveCounter`."""
    world = dist.get_world_size(group)
    dim = dim % t.dim()
    src = t.contiguous()
    host, timing = _staged(src)
    full = torch.empty((world, *src.shape), dtype=src.dtype, pin_memory=src.is_cuda)
    dist.all_gather(list(_as_bytes(full).unbind(0)), _as_bytes(host[None])[0], group=group)
    if src.is_cuda:
        full = full.to(src.device, non_blocking=True)
    shape = src.shape
    out = full.movedim(0, dim).reshape(*shape[:dim], world * shape[dim], *shape[dim + 1:])
    _record("all-gather", out, src.nbytes + out.nbytes if src.is_cuda else 0, timing)
    return out


def broadcast(t: torch.Tensor, group, src: int, timeout_s: Optional[float] = None
              ) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group``, written in
    place (a contiguous CPU tensor of the same shape and dtype on every
    rank). RuntimeError where it does not end within ``timeout_s`` seconds
    (None: the process group's timeout). Reports one ``broadcast`` of its
    bytes to the active :class:`~.scaling.CollectiveCounter`."""
    start = time.perf_counter()
    work = dist.broadcast(_as_bytes(t.reshape(1, -1))[0], src=src, group=group, async_op=True)
    if timeout_s is None:
        work.wait()
    else:
        work.wait(timeout=datetime.timedelta(seconds=timeout_s))
    record_collective("broadcast", t.nbytes, 0, seconds=time.perf_counter() - start)
    return t


def broadcast_variables(variables: Mapping[str, Mapping[str, torch.Tensor]], group=None,
                        src: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """Global rank ``src``'s ``{collection: {key: tensor}}`` on every rank of
    ``group`` (None: every rank), bit for bit, each leaf through host memory
    on its own device (:func:`broadcast`). Ranks that build the same seeded
    model may still round a float reduction of its calibration differently
    from process to process; this gives them one model."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for col, flat in variables.items():
        out[col] = {}
        for key, t in flat.items():
            host = broadcast(t.detach().cpu().contiguous().clone(), group, src)
            out[col][key] = host.to(t.device)
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, a new tensor on ``t``'s
    device (every rank gets the same bits). Reports one ``all-reduce`` of
    its bytes to the active :class:`~.scaling.CollectiveCounter`."""
    src = t.detach().contiguous()
    host, timing = _staged(src)
    if not src.is_cuda:
        host = host.clone()  # the reduce writes in place
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
    out = host.to(src.device, non_blocking=True) if src.is_cuda else host
    _record("all-reduce", out, 2 * src.nbytes if src.is_cuda else 0, timing)
    return out


class _GatherChannels(torch.autograd.Function):
    """Megatron's *g*: the slices gathered along ``dim``; the backward keeps
    this rank's slice of the gradient (every rank of the group holds the
    same whole gradient, since each runs the same whole computation after
    the gather)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.dim, ctx.rank = dim % t.dim(), dist.get_rank(group)
        ctx.n = t.shape[ctx.dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _IdentitySumGrad(torch.autograd.Function):
    """Megatron's *f*: the identity; the backward sums the gradient over the
    group (each rank's covers its slice of the out channels only)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def gather_channels(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """:func:`all_gather` along ``dim`` that autograd passes through: its
    backward returns this rank's slice of the gradient, and moves nothing."""
    return _GatherChannels.apply(t, group, dim)


def identity_sum_grad(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself, whose gradient is summed over ``group``
    (:func:`all_reduce`) on the way back."""
    return _IdentitySumGrad.apply(t, group)


class TPShard:
    """A layer's slice ``[lo, hi)`` of its ``n_out`` out channels on this
    rank of ``mesh``, and the forwards that gather the slices."""

    def __init__(self, mesh, n_out: int):
        tp = mesh.shape["model"]
        j = mesh.coords[1]
        self.mesh = mesh
        self.group = mesh.groups["model"]
        self.n_out = n_out
        self.lo, self.hi = j * n_out // tp, (j + 1) * n_out // tp

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole leaf's last axis: its out channels,
        or of a leaf with ``m`` values a channel in channel-major order
        (AWQ's group scales), the ``m`` of each of its channels."""
        m = t.shape[-1] // self.n_out
        return t[..., self.lo * m:self.hi * m].contiguous()

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The whole input of a training forward on the slice
        (:func:`identity_sum_grad`)."""
        return identity_sum_grad(x, self.group)

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        """A training forward's output slice gathered whole along channels
        (:func:`gather_channels`)."""
        return gather_channels(out, self.group)

    def run(self, local: Callable, x: torch.Tensor, residual=None, **kw) -> Any:
        """``local`` (the layer's packed forward on its slice) on the whole
        ``x`` and the residual's channels of the slice, then the output
        gathered along channels; a ``(out, qinput)`` pair keeps its int8
        input, which is whole on every rank."""
        if residual is not None:
            kw["residual"] = self.cut(residual)
        out = local(x, **kw)
        if isinstance(out, tuple):
            return (all_gather(out[0], self.group), *out[1:])
        return all_gather(out, self.group)


def _splits(layer, spec: Mapping[str, Any], in_attention: bool) -> bool:
    """Whether ``layer`` (its leaves' specs ``spec``) runs on its slice of
    the out channels: its weight was split over ``model`` and its forward
    is a per-channel function."""
    from ..nn.layers import QuantConv, QuantDense

    if in_attention or "w_p4" in spec:  # K8/K9 read the fused q/k/v; K4's split-half int4
        return False
    if isinstance(layer, QuantDense) and layer._use_p4(layer.in_features):
        return False  # its packed weights are split-half int4: whole in every mode
    if isinstance(layer, QuantConv) and ("w_int" in spec or "w_p4c" in spec) and (
            not layer.a_spec.enabled or layer.a_spec.per_channel or "awq_recip" in spec):
        return False  # its packed forward is a float conv (K3 takes per-tensor int8 only)
    weight = next((spec[k] for k in ("w_int", "w_p4c", "kernel") if k in spec), ())
    return "model" in weight and (not isinstance(layer, QuantConv)
                                  or layer.feature_group_count == 1)


def _is_slice(layer, owner, col: str, leaf: str, whole_len: int) -> bool:
    """Whether a split ``layer`` holds leaf ``col/leaf`` of ``owner`` (the
    layer or its weight quantizer) as its slice; ``whole_len``: the leaf's
    last axis, whole."""
    if owner is layer:
        return col in ("params", "packed") and leaf in LAYER_SLICES
    if col == "adaround":
        return leaf == "V"
    if col == "qobs":
        return (leaf in OBSERVER_SLICES and layer.w_spec.per_channel
                and layer.w_spec.range_name != "awq" and whole_len == layer.features)
    if col != "qparams" or leaf not in QUANTIZER_SLICES:
        return False
    if leaf in ("scale", "zero"):
        # one per out channel, or per AWQ group (``n_channels`` of them);
        # a per-tensor quantizer's are whole
        return layer.w_spec.per_channel and whole_len == layer.w_quantizer.n_channels
    return whole_len == layer.features


def attach(model: torch.nn.Module, variables: Mapping[str, Any],
           mods: Dict[str, Any]) -> Mapping[str, Any]:
    """Prepare ``variables`` for loading into ``model`` (``mods``: its
    variable modules by path). Every layer they hold leaves of (its own or
    its weight quantizer's) runs whole again, unless they are sharded over
    a ``model`` axis of 2 or more (:class:`~.mesh.ShardedVariables`): then
    each layer that splits gets its :class:`TPShard`, the leaves it holds as
    slices are cut where the spec left them whole, and every other sharded
    leaf is gathered whole. Returns the variables to load."""
    from ..convert import _owner, flatten
    from ..nn.attention import QuantMultiheadAttention
    from ..nn.layers import _QuantLayerBase

    flat = {col: flatten(tree) for col, tree in variables.items() if col != "taps"}
    owners = {col: {key: _owner(mods, key) for key in leaves} for col, leaves in flat.items()}
    layer_of: Dict[int, Any] = {}  # a layer, and its weight quantizer, to the layer
    for m in model.modules():
        if isinstance(m, _QuantLayerBase):
            layer_of[id(m)] = layer_of[id(m.w_quantizer)] = m
    touched = {id(layer_of[id(o)]): layer_of[id(o)]
               for col in owners.values() for o, _ in col.values() if id(o) in layer_of}
    for layer in touched.values():
        layer.set_tp_shard(None)
    mesh = getattr(variables, "mesh", None)
    set_data_group(model, mesh)
    if mesh is None or mesh.shape["model"] == 1:
        return variables
    tp = mesh.shape["model"]
    specs = {col: flatten(variables.spec[col]) for col in flat}
    in_attention = {id(m) for a in model.modules() if isinstance(a, QuantMultiheadAttention)
                    for m in a.modules()}
    layer_specs: Dict[int, Dict[str, Any]] = {}  # a layer's {leaf: spec}, every collection
    for col, keys in owners.items():
        for key, (owner, leaf) in keys.items():
            layer_specs.setdefault(id(owner), {})[leaf] = specs[col][key]
    for layer in touched.values():
        if _splits(layer, layer_specs.get(id(layer), {}), id(layer) in in_attention):
            layer.set_tp_shard(TPShard(mesh, layer.features))
    out: Dict[str, Dict[str, Any]] = {}
    for col, leaves in flat.items():
        out[col] = {}
        for key, value in leaves.items():
            owner, leaf = owners[col][key]
            spec = specs[col][key]
            layer = layer_of.get(id(owner))
            shard = None if layer is None else layer.tp_shard
            split_last = "model" in spec and spec.index("model") == len(spec) - 1
            whole_len = value.shape[-1] * (tp if split_last else 1) if value.dim() else 1
            if shard is not None and _is_slice(layer, owner, col, leaf, whole_len):
                if "model" not in spec:
                    value = shard.cut(value)
                elif not split_last:
                    raise ValueError(f"{col}/{key}: split on axis {spec.index('model')}, not "
                                     f"on the out channels its layer is split on")
            elif "model" in spec:
                value = all_gather(value, mesh.groups["model"], dim=spec.index("model"))
            out[col][key] = value
    return out


def set_data_group(model: torch.nn.Module, mesh) -> None:
    """Give every quantizer and layer of ``model`` the ``data`` group of
    ``mesh`` where it has two ``data`` ranks or more, else none (module
    docstring)."""
    from ..nn.layers import _QuantLayerBase
    from ..nn.quantizer import Quantizer
    from .mesh import axis_group

    group = axis_group(mesh, "data")
    for m in model.modules():
        if isinstance(m, (Quantizer, _QuantLayerBase)):
            m.data_group = group


def rank_variables(model: torch.nn.Module):
    """This rank's variables of ``model`` (``{collection: {"path/leaf":
    tensor}}``), as :class:`~.mesh.ShardedVariables` whose spec marks the
    leaves its split layers hold as slices (``"model"`` on the last axis),
    for :func:`~.mesh.gather_variables`. A model with no split layer gives
    a plain dict."""
    from ..nn.layers import _QuantLayerBase
    from ..nn.variables import collections, var_modules
    from .mesh import ShardedVariables

    sliced, mesh = set(), None
    for path, mod in var_modules(model):
        if not isinstance(mod, _QuantLayerBase) or mod.tp_shard is None:
            continue
        mesh = mod.tp_shard.mesh
        quantizer = "/".join(p for p in (path, "w_quantizer") if p)
        for owner, prefix in ((mod, path), (mod.w_quantizer, quantizer)):
            for col, leaf, t in owner.own_vars():
                n = t.shape[-1] if t.dim() else 1
                if _is_slice(mod, owner, col, leaf, n * mesh.shape["model"]):
                    sliced.add((col, f"{prefix}/{leaf}" if prefix else leaf))
    cols = collections(model)
    if mesh is None:
        return cols
    spec = {col: {key: (None,) * (t.dim() - 1) + ("model",) if (col, key) in sliced else ()
                  for key, t in flat.items()} for col, flat in cols.items()}
    return ShardedVariables(cols, mesh, spec)
