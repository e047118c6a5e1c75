"""Input pipeline: the host's slice of a batch and background device
prefetch.

PyTorch counterpart of ``quantize_tpu/parallel/input_pipeline.py``. A
background thread turns each numpy batch into tensors and places it (pinned
host memory, then a copy that does not block the host) on the mesh's device
or on ``device``, keeping ``prefetch`` batches ready, so that host IO and
decode overlap the device's work. Unlike the JAX iterator, an exception
raised by the source iterator reaches the consumer: iteration does not just
stop, so an eval over a loader that failed part way never reports a top-1
over fewer examples. Across processes (:mod:`torch.distributed`, a rank a
process) each process loads its slice of a global batch
(:func:`host_slice`), and :func:`shard_batch_to_mesh` assembles a rank's
rows along ``data`` from the slices of its ``model`` group.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist


def host_slice(global_batch: Mapping[str, np.ndarray], process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> Dict[str, np.ndarray]:
    """This process's slice of a global batch (a contiguous split on dim 0):
    process ``process_index`` of ``process_count``, by default this
    process's ``torch.distributed`` rank and world size (the whole batch
    where no process group is initialised)."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    out = {}
    for k, v in global_batch.items():
        per = len(v) // pc
        out[k] = v[pi * per:(pi + 1) * per]
    return out


def to_device(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """Each array of ``batch`` as a tensor on ``device``: on CUDA through
    pinned host memory and a copy that does not block the host (on the
    calling thread's current stream); on the CPU the array's own memory."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def shard_batch_to_mesh(mesh, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Place this process's slice of a global batch (:func:`host_slice` by
    rank) on the mesh: this rank's rows along ``data``, on its device. The
    ranks of one ``model`` group hold the same rows, so where ``tp > 1``
    their slices are gathered, in rank order, over that group."""
    if mesh.shape["model"] > 1:
        from .tensor_parallel import all_gather

        batch = {k: all_gather(v if isinstance(v, torch.Tensor)
                               else torch.from_numpy(np.ascontiguousarray(v)),
                               mesh.groups["model"], dim=0) for k, v in batch.items()}
    return to_device(batch, mesh.device)


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchIterator:
    """Wrap a host batch iterator with background loading and device
    placement (onto ``mesh``'s device where a mesh is given, else onto
    ``device``). Close it (or use it as a context manager) to stop the
    thread before the source is exhausted."""

    def __init__(self, it: Iterator[Mapping[str, Any]], mesh=None, prefetch: int = 2,
                 device="cuda"):
        self._it = it
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._done = object()
        self._finished = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="qtt-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self) -> None:
        try:
            for batch in self._it:
                if not self._put(to_device(batch, self.device)):
                    return
        except Exception as exc:  # handed to the consumer, which re-raises it
            self._put(_Raised(exc))
        finally:
            self._put(self._done)

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._finished = True
            raise StopIteration
        if isinstance(item, _Raised):
            self._finished = True
            raise item.exc
        return item

    def close(self, timeout: float = 30.0) -> None:
        """Stop the background thread and drop the batches it holds."""
        self._stop.set()
        self._finished = True
        self._thread.join(timeout=timeout)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_to_mesh(loader, mesh=None, prefetch: int = 2, per_host: bool = False,
                     device="cuda") -> PrefetchIterator:
    """Iterate a DataLoader with device prefetch; with ``per_host`` each
    batch is first sliced to this process (:func:`host_slice`): on a mesh,
    to this rank's rows along ``data``, which its ``model`` group shares."""
    def gen():
        for batch in loader:
            if per_host and mesh is not None:
                batch = host_slice(batch, mesh.coords[0], mesh.shape["data"])
            elif per_host:
                batch = host_slice(batch)
            yield batch

    return PrefetchIterator(gen(), mesh=mesh, prefetch=prefetch, device=device)
