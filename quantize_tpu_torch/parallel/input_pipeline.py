"""Input pipeline: the host's slice of a batch and background device
prefetch.

PyTorch counterpart of ``quantize_tpu/parallel/input_pipeline.py``. A
background thread turns each numpy batch into tensors and places it (pinned
host memory, then a copy that does not block the host) on the mesh's device
or on ``device``, keeping ``prefetch`` batches ready, so that host IO and
decode overlap the device's work. Unlike the JAX iterator, an exception
raised by the source iterator reaches the consumer: iteration does not just
stop, so an eval over a loader that failed part way never reports a top-1
over fewer examples. Slicing a global batch over several processes is kept
(:func:`host_slice`); placing it over several devices is not ported yet.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Mapping

import numpy as np
import torch

from .mesh import shard_batch


def host_slice(global_batch: Mapping[str, np.ndarray], process_index: int = 0,
               process_count: int = 1) -> Dict[str, np.ndarray]:
    """This process's slice of a global batch (a contiguous split on dim 0):
    process ``process_index`` of ``process_count``, by default the whole
    batch."""
    out = {}
    for k, v in global_batch.items():
        per = len(v) // process_count
        out[k] = v[process_index * per:(process_index + 1) * per]
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


# JAX's two names for one placement rule (the mesh's own and the pipeline's)
shard_batch_to_mesh = shard_batch


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
    batch is first sliced to this process (:func:`host_slice`)."""
    def gen():
        for batch in loader:
            yield host_slice(batch) if per_host else batch

    return PrefetchIterator(gen(), mesh=mesh, prefetch=prefetch, device=device)
