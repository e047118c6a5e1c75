"""Device mesh and sharding rules.

PyTorch counterpart of ``quantize_tpu/parallel/mesh.py``: a 2-D mesh
``(data, model)`` of ranks, the tensor-parallel rules that say which axis of
each variable is split over ``model`` (:func:`spec_for_variables`, JAX's
rules), and the placement of variables and batches onto the mesh.

A mesh of one device places everything on that device. A larger mesh is one
process a rank over a ``torch.distributed`` group (:func:`init_distributed`,
gloo): rank ``r`` sits at ``(r // tp, r % tp)`` (JAX's row-major layout)
on its own local device, ``cuda:(r % device_count())`` by default, so that
ranks may share a card. Each rank keeps its slice of every leaf split over
``model`` and the whole of the rest (:func:`shard_variables`), and its rows
of a batch along ``data`` (:func:`shard_batch`). The collectives go over
gloo sub-groups, one for each ``data`` row (the ``model`` group) and each
``model`` column (the ``data`` group): never NCCL, which refuses two ranks on
one card.

A spec is a tuple with one entry per axis of the leaf, ``"model"`` on the
axis split over the model axis and None elsewhere; ``()`` replicates the
leaf (JAX's ``PartitionSpec`` entries as a tuple).
"""
from __future__ import annotations

import datetime
import socket
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
# leaves split on their last (out-channel) axis
_OUT_CHANNEL_LEAVES = {"kernel", "w_int", "w_p4", "w_p4c"}
# per-out-channel vectors
_CHANNEL_VECTOR_LEAVES = {"bias", "w_scale", "w_zero", "scale", "zero", "col_sum"}


def free_port() -> int:
    """A TCP port free on the loopback interface now (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(rank: int, world_size: int, port: int, timeout_s: float = 300.0) -> None:
    """Join a ``world_size``-process group as ``rank`` over gloo, with the
    store at ``tcp://127.0.0.1:port`` (rank 0 hosts it)."""
    dist.init_process_group(backend="gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


class Mesh:
    """A ``(dp, tp)`` array of ``torch.device``s, one a rank, with the axis
    names ``("data", "model")``. ``rank`` is this process's place in it;
    ``groups`` holds the gloo groups of this rank's ``data`` column and
    ``model`` row (empty on a mesh of one device)."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, rank: int = 0,
                 groups: Optional[Dict[str, Any]] = None):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        self.rank = rank
        self.groups = groups or {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's ``(data, model)`` index."""
        return divmod(self.rank, self.shape["model"])

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices.flat[self.rank]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank}, {list(self.devices.flat)})"


def axis_group(mesh: Optional[Mesh], axis: str):
    """``mesh``'s gloo group along ``axis`` (``"data"`` or ``"model"``)
    where that axis has two ranks or more; else None (no mesh, or nothing to
    reduce over)."""
    return mesh.groups[axis] if mesh is not None and mesh.shape[axis] > 1 else None


def make_mesh(dp: int = 1, tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data=dp, model=tp)`` mesh. One device: the first of ``devices``
    (default: the visible CUDA devices). More: every process of a
    ``dp * tp``-rank ``torch.distributed`` group calls this, in the same
    order, and rank ``r`` runs on ``devices[r]`` (default:
    ``cuda:(r % device_count())``)."""
    n = dp * tp
    if devices is None:
        count = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(count)] if n == 1
                   else [torch.device("cuda", r % count) for r in range(n)] if count else [])
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    arr = arr.reshape(dp, tp)
    if n == 1:
        return Mesh(arr)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(f"a ({dp}, {tp}) mesh of {n} ranks needs torch.distributed "
                           f"initialised with {n} processes, one a rank (world size {world}; "
                           f"see init_distributed)")
    rank = dist.get_rank()
    ranks = np.arange(n).reshape(dp, tp)
    groups = {}
    # every rank creates every group, in one order; each keeps its own
    for axis, lines in (("model", ranks), ("data", ranks.T)):
        for line in lines:
            group = dist.new_group([int(r) for r in line], backend="gloo")
            if rank in line:
                groups[axis] = group
    return Mesh(arr, rank, groups)


def _leaf_spec(name: str, leaf: Any, tp: int) -> Tuple:
    shape = tuple(getattr(leaf, "shape", ()))
    if name in _OUT_CHANNEL_LEAVES and len(shape) >= 2:
        if shape[-1] % tp == 0 and shape[-1] >= tp:
            return (None,) * (len(shape) - 1) + ("model",)
    if name in _CHANNEL_VECTOR_LEAVES and len(shape) == 1:
        if shape[0] % tp == 0 and shape[0] >= tp:
            return ("model",)
    return ()


def spec_for_variables(variables: Mapping[str, Any], tp: int) -> Dict[str, Any]:
    """The spec of every leaf of ``variables`` (nested dicts, the JAX
    layout, or the port's ``{collection: {"path/leaf": tensor}}``), in the
    same containers. A leaf's name is the last ``/`` part of its key."""
    return {k: spec_for_variables(v, tp) if isinstance(v, Mapping)
            else _leaf_spec(str(k).rsplit("/", 1)[-1], v, tp)
            for k, v in variables.items()}


class ShardedVariables(dict):
    """Variables placed on one rank of ``mesh``: each leaf that ``spec``
    splits over ``model`` holds this rank's slice. Loading them into a
    model (:func:`~quantize_tpu_torch.convert.from_jax_variables`) makes its
    layers run tensor-parallel (:mod:`.tensor_parallel`)."""

    def __init__(self, tree: Mapping[str, Any], mesh: Mesh, spec: Mapping[str, Any]):
        super().__init__(tree)
        self.mesh = mesh
        self.spec = spec


def _as_tensor(leaf: Any) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))


def _place(tree: Any, spec: Any, device: torch.device, part: Tuple[int, int]) -> Any:
    if isinstance(tree, Mapping):
        return {k: _place(v, spec[k], device, part) for k, v in tree.items()}
    t = _as_tensor(tree)
    if "model" in spec:
        index, count = part
        axis = spec.index("model")
        n = t.shape[axis] // count
        t = t.narrow(axis, index * n, n)
    return t.to(device).contiguous()


def shard_variables(mesh: Mesh, variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Place ``variables`` onto this rank of the mesh by the tensor-parallel
    rules: on its device, each leaf split over ``model`` cut to this rank's
    slice, the rest whole (tensors, in the same containers). On a mesh of
    one device, every leaf whole on that device."""
    if mesh.size == 1:
        return _place(variables, spec_for_variables(variables, 1), mesh.device, (0, 1))
    tp = mesh.shape["model"]
    spec = spec_for_variables(variables, tp)
    return ShardedVariables(_place(variables, spec, mesh.device, (mesh.coords[1], tp)),
                            mesh, spec)


def _gather(tree: Any, spec: Any, group) -> Any:
    from .tensor_parallel import all_gather

    if isinstance(tree, Mapping):
        return {k: _gather(v, spec[k], group) for k, v in tree.items()}
    t = _as_tensor(tree).detach()
    return all_gather(t, group, dim=spec.index("model")) if "model" in spec else t


def gather_variables(mesh: Mesh, variables: Mapping[str, Any]) -> Dict[str, Any]:
    """This rank's variables brought back whole (JAX's ``jax.device_get`` of
    a sharded tree): each leaf that ``variables`` (a
    :class:`ShardedVariables`: :func:`shard_variables`' output, or
    :func:`~.tensor_parallel.rank_variables` of a model) holds as a slice is
    gathered over ``model``, one collective a leaf; the rest is returned as
    it is, in the same containers. Plain variables are returned as they
    are."""
    spec = getattr(variables, "spec", None)
    if spec is None or mesh.shape["model"] == 1:
        return dict(variables)
    return _gather(dict(variables), spec, mesh.groups["model"])


def shard_batch(mesh: Mesh, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch dict, split over ``data`` (a
    contiguous split on dim 0), on its device (pinned, copied without
    blocking the host); a mesh of one device keeps every row."""
    from .input_pipeline import host_slice, to_device

    dp = mesh.shape["data"]
    if dp > 1:
        batch = host_slice(batch, process_index=mesh.coords[0], process_count=dp)
    return to_device(batch, mesh.device)
