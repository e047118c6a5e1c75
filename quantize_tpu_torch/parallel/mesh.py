"""Device mesh and sharding rules.

PyTorch counterpart of ``quantize_tpu/parallel/mesh.py``: a 2-D mesh
``(data, model)`` of devices, the tensor-parallel rules that say which axis
of each variable would be split over ``model`` (:func:`spec_for_variables`,
pure logic, JAX's rules for any ``tp``), and the placement of variables and
batches onto the mesh. Only a mesh of one device places anything: spreading
a model or a batch over several cards is not ported yet
(:func:`~quantize_tpu_torch.utils.registry.not_ported_error`, item 6).

A spec is a tuple with one entry per axis of the leaf, ``"model"`` on the
axis split over the model axis and None elsewhere; ``()`` replicates the
leaf (JAX's ``PartitionSpec`` entries as a tuple).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.registry import not_ported_error

AXES = ("data", "model")
# leaves split on their last (out-channel) axis
_OUT_CHANNEL_LEAVES = {"kernel", "w_int", "w_p4", "w_p4c"}
# per-out-channel vectors
_CHANNEL_VECTOR_LEAVES = {"bias", "w_scale", "w_zero", "scale", "zero", "col_sum"}


class Mesh:
    """A ``(dp, tp)`` array of ``torch.device``s with the axis names
    ``("data", "model")``."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The device of a one-device mesh; a larger mesh raises."""
        if self.size != 1:
            raise not_ported_error(f"a mesh of more than one device ({self.shape}: tensor or "
                                   f"data parallel placement)", 6)
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def make_mesh(dp: int = 1, tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data=dp, model=tp)`` mesh of the first ``dp * tp`` devices
    (default: the visible CUDA devices)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = dp * tp
    if len(devices) < n:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(dp, tp))


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


def _place(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _place(v, device) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))
    return t.to(device)


def shard_variables(mesh: Mesh, variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Place ``variables`` onto the mesh by the tensor-parallel rules: on a
    mesh of one device, every leaf on that device (tensors, in the same
    containers)."""
    return _place(variables, mesh.device)


def shard_batch(mesh: Mesh, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Place every array of a batch dict on the mesh, split over ``data``:
    on a mesh of one device, on that device (pinned, copied without
    blocking the host)."""
    from .input_pipeline import to_device

    return to_device(batch, mesh.device)
