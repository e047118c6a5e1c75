"""Continuous-batching inference engine.

PyTorch counterpart of ``quantize_tpu/parallel/serving.py``: an image-stream
server that

* accepts requests from any number of producer threads (one image, a list
  of images, or a stacked chunk with one result future),
* coalesces them into batches of one fixed shape, padding the tail, so
  that every forward runs the same kernels at the same shapes,
* assembles each batch into pinned host memory on a staging thread, so
  that the copy of the next batch overlaps the dispatch of this one (the
  forward is dispatched op by op from Python, which takes host time of the
  order of the device's),
* dispatches from a thread that does not wait for the device: each batch's
  host-to-device copy, forward and device-to-host copy are queued on that
  thread's current CUDA stream, and a CUDA event marks the batch's end, and
* resolves futures from a drain thread that waits on that batch's event
  only, so the next batches are staged and queued while the device works.

With a mesh the engine serves on this rank's device: on a mesh of one
device, or one rank of a data-parallel mesh (each rank serving its own
requests with the whole model). On a mesh with a ``model`` axis of two or
more (the model loaded with ``shard_variables``, its layers on slices) the
ranks of one ``model`` group must run the same batches, which JAX gets from
its single controller's one queue (``quantize_tpu/parallel/serving.py:
304-310``). Here the group's rank at ``model`` index 0 is the **leader**:
it takes the requests, forms each batch and broadcasts it to the group
(a small header, then the staged rows), and resolves the futures. The
other ranks **follow**: :meth:`InferenceEngine.start` runs a thread that
receives each batch and runs the same forward on it (its collectives meet
the leader's), dropping the result; their ``submit*`` raises. The header
carries the packed precision switches the leader fixed at its start, and a
follower runs each batch under them, so the slices of one output are
computed alike whatever the follower's own switches. The leader's
``stop()`` ends its followers' loops; an idle leader sends a keep-alive
header every second, and a follower that hears nothing from its leader for
``_FOLLOW_TIMEOUT_S`` seconds fails (``stop()`` on it raises). Each
data-parallel row of a ``(dp, tp)`` mesh has its own leader.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..nn import precision
from ..profiling import span, spanned


# how long stop() waits for each thread before it fails what is not yet served
_STOP_TIMEOUT_S = 30.0
# a leader's header to its followers, int64: (kind, rows, ndim, up to four
# dims, the precision switches' code)
_HEADER = 8
_KEEPALIVE, _BATCH, _STOP = 0, 1, 2
# how often an idle leader tells its followers it is there
_KEEPALIVE_S = 1.0
# how long a follower waits for a word from its leader before it fails
_FOLLOW_TIMEOUT_S = 60.0
_CARRIES = (torch.float32, torch.bfloat16)


def _switches_code(settings: tuple) -> int:
    """The packed precision switches ``(carry dtype, fused residual tail,
    int8 carry)`` as one integer."""
    carry, fused, qin = settings
    return _CARRIES.index(carry) | int(fused) << 1 | int(qin) << 2


def _switches(code: int):
    """The switches of ``code`` while the context lasts."""
    stack = contextlib.ExitStack()
    stack.enter_context(precision.packed_carry(_CARRIES[code & 1]))
    stack.enter_context(precision.fused_residual(bool(code & 2)))
    stack.enter_context(precision.qin_carry(bool(code & 4)))
    return stack


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _materialize_local_rows(out, n_rows: Optional[int] = None) -> np.ndarray:
    """A batch result on the host as numpy: a tensor whole, or a rank's
    rows from pieces ``[(rows, tensor), ...]`` (``rows`` a ``range`` or a
    ``slice`` with bounds), each placed at its rows. The pieces must tile
    ``[0, n_rows)`` exactly (default: up to the last row given); a gap or
    an overlap raises ValueError, where JAX's counterpart would fill rows it
    never wrote."""
    if isinstance(out, torch.Tensor):
        return out.numpy().copy()
    spans = sorted(((r.start, r.stop, t) for r, t in out), key=lambda s: s[:2])
    n_rows = spans[-1][1] if n_rows is None else n_rows
    bounds = [(lo, hi) for lo, hi, _ in spans]
    at = 0
    for lo, hi, t in spans:
        if lo != at:
            raise ValueError(f"the row pieces {bounds} do not tile [0, {n_rows}): rows "
                             f"{min(lo, at)}..{max(lo, at)} "
                             f"{'overlap' if lo < at else 'are missing'}")
        if hi - lo != len(t):
            raise ValueError(f"the piece of rows [{lo}, {hi}) holds {len(t)} rows")
        at = hi
    if at != n_rows:
        raise ValueError(f"the row pieces end at row {at}, not {n_rows}: rows missing")
    return np.concatenate([t.numpy() for _, _, t in spans])


def _default_preprocess(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


class InferenceEngine:
    """Continuous batching over ``model(preprocess(x), mode=mode)``.

    The model holds its state: pass ``variables`` (deploy variables under
    their flax names, the port's layout or JAX's nested one) to load them
    with :func:`~quantize_tpu_torch.convert.from_jax_variables`, or pack the
    model beforehand and leave it None.

    Warm the model before :meth:`start` with one forward at the serving
    shape: the first packed forward builds the CUDA kernel libraries (tens
    of seconds of ``nvcc``), and futures that wait on it may time out.

    The precision switches (:mod:`~quantize_tpu_torch.nn.precision`: the
    carry dtype, the fused residual tail, the int8 carry) are process-wide
    and read on every forward. The engine records them at :meth:`start`;
    a batch dispatched after they changed, or while they change, fails its
    futures with RuntimeError and is never served with mixed settings.

    Results come back as numpy arrays; a bfloat16 output (bf16 carry) is
    widened to float32 on the device, which is exact.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        variables: Optional[Mapping[str, Any]] = None,
        batch_size: int = 32,
        mode: str = "packed",
        mesh=None,
        max_wait_ms: float = 2.0,
        max_queue: int = 4096,
        max_in_flight: int = 4,
        input_dtype=np.float32,
        preprocess: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        postprocess: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        frame_pool=None,
        device="cuda",
    ):
        """``device``: where the model runs (CUDA unless the caller passes
        ``"cpu"``); with ``mesh`` the mesh's device.

        ``input_dtype``/``preprocess``: ship compact pixels. uint8 images
        quarter the host-to-device copy; ``preprocess`` runs on the device
        on each batch before the model (default: cast to float32; pass e.g.
        a normalize taking and returning the batch).

        ``postprocess``: runs on the device on the batch output (e.g.
        ``lambda o: o.argmax(-1)`` for top-1), which shrinks the result
        each batch copies back.

        ``frame_pool``: a device-resident ``(P, H, W, C)`` tensor of frames.
        When given, a request is an int index into the pool instead of an
        image; the host ships one ``(B,)`` int32 index vector a batch and
        the frames are gathered on the device. This isolates the engine's
        own overhead (queuing, batching window, dispatch, drain) from the
        host-to-device copy of the pixels.

        ``max_queue`` bounds queued chunks, not requests: ``submit`` puts a
        chunk of one, ``submit_many`` and ``submit_batch`` chunks of up to
        ``batch_size`` (``stats()["queue_depth"]`` counts chunks too)."""
        self.tp = 1 if mesh is None else mesh.shape["model"]
        self.is_leader = True
        if self.tp > 1:
            group = getattr(mesh, "groups", {}).get("model")
            if (group is None or not dist.is_initialized()
                    or dist.get_world_size(group) != self.tp):
                raise RuntimeError(f"the engine on a tensor-parallel mesh ({mesh.shape}) needs "
                                   f"the mesh's model group of {self.tp} ranks (make_mesh under "
                                   f"torch.distributed, one process a rank)")
            self._group = group
            self._leader = mesh.rank - mesh.coords[1]  # the group's global rank at index 0
            self.is_leader = mesh.coords[1] == 0
        self.device = mesh.device if mesh is not None else torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the engine serves on CUDA, and torch sees no CUDA device; "
                               "pass device='cpu' to serve on the CPU")
        self.model = model.to(self.device)
        if variables is not None:
            from ..convert import from_jax_variables

            from_jax_variables(self.model, variables)
        self.batch_size = int(batch_size)
        self.mode = mode
        self.mesh = mesh
        self.input_dtype = np.dtype(input_dtype)
        self.max_wait_s = max_wait_ms / 1e3
        self.preprocess = preprocess or _default_preprocess
        self.postprocess = postprocess or (lambda o: o)
        self.frame_pool = None
        if frame_pool is not None:
            self.frame_pool = torch.as_tensor(frame_pool, device=self.device)
            self.input_dtype = np.dtype(np.int32)
        self._in_dtype = _torch_dtype(self.input_dtype)
        # chunks (images[n, ...], sinks, the host clock at the put), each
        # sink (future, n_requests)
        self._queue: "queue.Queue[tuple]" = queue.Queue(maxsize=int(max_queue))
        self._pending: List[tuple] = []  # the staging thread's leftover chunks
        # (host batch or None, sinks, n_requests, staging error, the sum of
        # the requests' put times) between staging and dispatch: two batches
        # staged ahead at most
        self._staged: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=2)
        # (host result, CUDA event, sinks) between dispatch and drain
        self._inflight: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=max(1, int(max_in_flight)))
        self._stop = threading.Event()
        self._stage_thread: Optional[threading.Thread] = None
        self._thread: Optional[threading.Thread] = None
        self._drain_thread: Optional[threading.Thread] = None
        self._settings: Optional[tuple] = None
        self.n_processed = 0
        self.n_batches = 0
        self.n_failed = 0
        self.max_observed_in_flight = 0
        self._abandoned: Optional[Exception] = None  # set by a stop() that timed out
        self._fail_lock = threading.Lock()  # n_failed is counted from several threads
        self.staging_s = 0.0  # host time assembling batches into pinned memory
        self.dispatch_s = 0.0  # host time queuing the copies and forwards
        self.queue_wait_s = 0.0  # summed over requests: put to their batch's dispatch
        # tensor parallel: the batches' broadcasts (header and rows) to the
        # followers, and a follower's failure
        self.broadcast_s = 0.0
        self.broadcast_bytes = 0
        self._follow_thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "InferenceEngine":
        """Start the staging, dispatch and drain threads, recording the
        precision switches every batch is then served with; on a follower,
        the thread that runs the leader's batches."""
        if not self.is_leader:
            if self._follow_thread is None:
                self.error = None
                self._follow_thread = threading.Thread(target=self._follow, daemon=True,
                                                       name="qtt-engine-follow")
                self._follow_thread.start()
            return self
        if any(t is not None for t in (self._stage_thread, self._thread, self._drain_thread)):
            if self._stop.is_set():
                raise RuntimeError("the engine's threads have not ended since stop() timed "
                                   "out; call stop() again before start()")
            return self
        self._settings = precision.packed_settings()[1:]
        self._abandoned = None
        self._stop.clear()
        self._drain_thread = threading.Thread(target=self._drain, daemon=True,
                                              name="qtt-engine-drain")
        self._drain_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="qtt-engine-dispatch")
        self._thread.start()
        self._stage_thread = threading.Thread(target=self._stage_loop, daemon=True,
                                              name="qtt-engine-stage")
        self._stage_thread.start()
        return self

    def stop(self) -> None:
        """Serve what is queued, then stop the threads. Each thread hands its
        end marker to the next as it ends, so the drain ends after the
        dispatch loop's last batch. A thread still running after 30 s (a
        first forward that builds the kernels behind a backlog) fails every
        request not yet dispatched with RuntimeError; the batch being
        dispatched still resolves, and the threads stay recorded, so that
        :meth:`start` cannot run a second loop beside them: call stop()
        again to wait for them.

        On a follower: wait until its leader stops (or the follower fails,
        at the latest ``_FOLLOW_TIMEOUT_S`` after the leader's last word),
        then raise RuntimeError where it failed."""
        if not self.is_leader:
            if self._follow_thread is not None:
                self._follow_thread.join()
                self._follow_thread = None
            if self.error is not None:
                raise RuntimeError(f"the follower's leader (rank {self._leader}) failed or went "
                                   f"silent: {self.error}") from self.error
            return
        self._stop.set()
        for attr in ("_stage_thread", "_thread", "_drain_thread"):
            thread = getattr(self, attr)
            if thread is None:
                continue
            thread.join(timeout=_STOP_TIMEOUT_S)
            if thread.is_alive():
                self._abandon(RuntimeError(f"the engine stopped after {_STOP_TIMEOUT_S} s "
                                           f"with this request not yet served"))
                return
            setattr(self, attr, None)

    def _abandon(self, exc: Exception) -> None:
        """Fail the requests not yet dispatched; the threads fail what they
        hold or take later."""
        self._abandoned = exc
        for q in (self._queue, self._staged):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is None:  # the staging thread's end marker, for the dispatch loop
                    q.put(item)
                    break
                self._fail(item[1], exc)

    def _fail(self, sinks: List[tuple], exc: BaseException) -> None:
        for fut, _ in sinks:
            if not fut.done():
                fut.set_exception(exc)
        with self._fail_lock:
            self.n_failed += sum(n for _, n in sinks)

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API -------------------------------------------------------
    def _check_leader(self) -> None:
        if not self.is_leader:
            raise RuntimeError(f"this rank follows its model group's leader (rank "
                               f"{self._leader}) on a tensor-parallel mesh: submit there")

    def submit(self, image) -> Future:
        """One request; its future resolves to its result."""
        self._check_leader()
        fut: Future = Future()
        self._queue.put((np.asarray(image, self.input_dtype)[None], [(fut, 1)],
                         time.perf_counter()))
        return fut

    def _put_chunks(self, images, sinks_for) -> List[Future]:
        """Stack once and put one queue entry per ``batch_size`` slice;
        ``sinks_for(futs, lo, hi)`` builds a chunk's sinks and appends its
        futures to ``futs``. ``images`` carries a leading request axis (a
        sequence of images or one stacked array): pass ``image[None]`` for
        one image, or use :meth:`submit`."""
        self._check_leader()
        arr = np.asarray(images, self.input_dtype)
        futs: List[Future] = []
        t = time.perf_counter()
        for lo in range(0, len(arr), self.batch_size):
            hi = min(lo + self.batch_size, len(arr))
            self._queue.put((arr[lo:hi], sinks_for(futs, lo, hi), t))
        return futs

    def submit_many(self, images: Sequence) -> List[Future]:
        """One queue entry per up to ``batch_size`` requests, one future per
        request (the i-th resolves to the i-th request's result)."""
        def sinks(futs, lo, hi):
            new = [Future() for _ in range(hi - lo)]
            futs.extend(new)
            return [(f, 1) for f in new]

        return self._put_chunks(images, sinks)

    def submit_batch(self, images) -> List[Future]:
        """One future per chunk of up to ``batch_size`` requests, resolving
        to the chunk's stacked ``(n, ...)`` results: no future per request,
        the client API for a frontend that holds many requests."""
        def sinks(futs, lo, hi):
            fut: Future = Future()
            futs.append(fut)
            return [(fut, hi - lo)]

        return self._put_chunks(images, sinks)

    def stats(self) -> Dict[str, float]:
        """Counts since construction. ``max_observed_in_flight``: the most
        batches waiting for the drain, the one being handed to it included,
        seen at a dispatch (2 or more: a batch was queued before the drain
        took the one ahead of it). ``staging_ms`` and ``dispatch_ms``: host
        time a batch on the staging and the dispatch thread.
        ``queue_wait_ms``: host time a request waits, from its ``submit*``
        to the start of its batch's dispatch, over the requests served."""
        batches = max(self.n_batches, 1)
        return {
            "broadcast_ms": 1e3 * self.broadcast_s / batches,
            "broadcast_bytes": self.broadcast_bytes / batches,
            "processed": self.n_processed,
            "batches": self.n_batches,
            "failed": self.n_failed,
            "mean_batch_fill": self.n_processed / batches / self.batch_size,
            "queue_depth": self._queue.qsize(),
            "max_observed_in_flight": self.max_observed_in_flight,
            "staging_ms": 1e3 * self.staging_s / batches,
            "dispatch_ms": 1e3 * self.dispatch_s / batches,
            "queue_wait_ms": 1e3 * self.queue_wait_s / max(self.n_processed, 1),
        }

    # -- server loop ------------------------------------------------------
    def _collect(self) -> "tuple[List[tuple], int]":
        """Assemble up to ``batch_size`` requests from leftover chunks and
        the queue (blocking briefly for the first chunk, then draining
        within the batching window). Returns ``(chunks, n_requests)``;
        per-request chunks past ``batch_size`` are split and the rest kept
        for the next batch."""
        pieces = self._pending
        self._pending = []
        total = sum(n for _, sinks, _ in pieces for _, n in sinks)
        if total == 0:
            try:
                c = self._queue.get(timeout=0.05)
            except queue.Empty:
                return pieces, 0
            pieces.append(c)
            total += sum(n for _, n in c[1])
        if total < self.batch_size:
            deadline = time.perf_counter() + self.max_wait_s
            while total < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    c = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                pieces.append(c)
                total += sum(n for _, n in c[1])
        if total > self.batch_size:
            imgs, sinks, t = pieces.pop()
            n_last = sum(n for _, n in sinks)
            if all(n == 1 for _, n in sinks):
                keep = n_last - (total - self.batch_size)
                pieces.append((imgs[:keep], sinks[:keep], t))
                self._pending = [(imgs[keep:], sinks[keep:], t)]
                total = self.batch_size
            else:
                # a chunk's one future cannot be split: defer the whole chunk
                # (this batch goes out underfilled, padded)
                self._pending = [(imgs, sinks, t)]
                total -= n_last
        return pieces, total

    def _stage(self, pieces: List[tuple]) -> torch.Tensor:
        """Copy the batch's requests into one host buffer of ``batch_size``
        rows (pinned on CUDA) and zero the padding. A request whose shape
        differs from the first raises."""
        shape = pieces[0][0].shape[1:]
        for imgs, _, _ in pieces:
            if imgs.shape[1:] != shape:
                raise ValueError(f"a request of shape {imgs.shape[1:]} in a batch of {shape}")
        buf = torch.empty((self.batch_size, *shape), dtype=self._in_dtype,
                          pin_memory=self.device.type == "cuda")
        off = 0
        for imgs, _, _ in pieces:
            rows = buf[off:off + len(imgs)]
            if imgs.flags.writeable:  # torch's copy runs on the intra-op threads
                rows.copy_(torch.from_numpy(imgs))
            else:
                np.copyto(rows.numpy(), imgs)
            off += len(imgs)
        buf[off:] = 0
        return buf

    def _stage_loop(self) -> None:
        try:
            self._stage_batches()
        finally:
            self._staged.put(None)  # after the last batch: the dispatch loop ends

    def _stage_batches(self) -> None:
        while not self._stop.is_set() or not self._queue.empty() or self._pending:
            pieces, n = self._collect()
            if n == 0:
                continue
            sinks = [s for _, ss, _ in pieces for s in ss]
            if self._abandoned is not None:
                self._fail(sinks, self._abandoned)
                continue
            put_s = sum(t * k for _, ss, t in pieces for _, k in ss)
            t0 = time.perf_counter()
            with span("engine.stage"):
                try:
                    # one request of the wrong shape fails its batch, not the thread
                    item = (self._stage(pieces), sinks, n, None, put_s)
                except Exception as exc:  # handed to the batch's futures
                    item = (None, sinks, n, exc, put_s)
            self.staging_s += time.perf_counter() - t0
            self._staged.put(item)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.frame_pool is not None:
            x = self.frame_pool.index_select(0, x.long())
        out = self.postprocess(self.model(self.preprocess(x), mode=self.mode))
        return out.float() if out.dtype == torch.bfloat16 else out

    def _check_settings(self, before: tuple) -> None:
        now = precision.packed_settings()
        if before[1:] != self._settings or now != before:
            raise RuntimeError(
                f"the packed precision switches (carry dtype, fused residual tail, int8 "
                f"carry) changed while the engine runs: {self._settings} at start(), "
                f"{now[1:]} now; set them before start()")

    def _announce(self, kind: int, buf: Optional[torch.Tensor] = None, n: int = 0) -> None:
        """The leader's word to its followers: a header, then a batch's rows."""
        from .tensor_parallel import broadcast

        hdr = torch.zeros(_HEADER, dtype=torch.int64)
        hdr[0], hdr[1] = kind, n
        hdr[_HEADER - 1] = _switches_code(self._settings)
        if buf is not None:
            if buf.dim() > _HEADER - 4:
                raise ValueError(f"a batch of {buf.dim()} dims does not fit the header")
            hdr[2] = buf.dim()
            hdr[3:3 + buf.dim()] = torch.tensor(buf.shape)
        t0 = time.perf_counter()
        broadcast(hdr, self._group, self._leader)
        if buf is not None:
            broadcast(buf, self._group, self._leader)
            self.broadcast_s += time.perf_counter() - t0
            self.broadcast_bytes += hdr.nbytes + buf.nbytes

    @spanned("engine.dispatch")
    def _dispatch(self, buf: torch.Tensor, n: int = 0) -> tuple:
        """Queue one staged batch's copy to the device, its forward and the
        result's copy to the host (on a tensor-parallel mesh after the
        batch went to the followers); returns ``(host result, CUDA event or
        None)``."""
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        x = buf.to(self.device, non_blocking=True) if cuda else buf
        before = precision.packed_settings()
        self._check_settings(before)
        if self.tp > 1:
            self._announce(_BATCH, buf, n)
        out = self._forward(x)
        self._check_settings(before)
        if cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            # a blocking-sync event: the drain sleeps on it instead of
            # spinning a core that the dispatch thread's Python needs
            done = torch.cuda.Event(blocking=True)
            done.record()
        else:
            host, done = out, None
        self.dispatch_s += time.perf_counter() - t0
        return host, done

    def _loop(self) -> None:
        try:
            self._dispatch_loop()
        finally:
            try:
                if self.tp > 1:
                    self._announce(_STOP)  # the followers' loops end
            finally:
                self._inflight.put(None)  # after the last batch: the drain ends

    def _dispatch_loop(self) -> None:
        # grad mode and the current device are per thread
        device_ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
                      else contextlib.nullcontext())
        with torch.inference_mode(), device_ctx:
            while True:
                if self.tp > 1:
                    try:
                        item = self._staged.get(timeout=_KEEPALIVE_S)
                    except queue.Empty:
                        self._announce(_KEEPALIVE)  # idle: the followers keep waiting
                        continue
                else:
                    item = self._staged.get()
                if item is None:
                    return
                buf, sinks, n, error, put_s = item
                try:
                    if error is not None:
                        raise error
                    if self._abandoned is not None:
                        self._fail(sinks, self._abandoned)
                        continue
                    t = time.perf_counter()
                    host, done = self._dispatch(buf, n)
                    del buf  # back to the pinned cache once its copy has run
                    self.max_observed_in_flight = max(self.max_observed_in_flight,
                                                      self._inflight.qsize() + 1)
                    self._inflight.put((host, done, sinks))
                except Exception as exc:  # handed to the batch's futures
                    self._fail(sinks, exc)
                    continue  # failed batches stay out of the throughput stats
                self.n_processed += n
                self.n_batches += 1
                self.queue_wait_s += n * t - put_s

    def _drain(self) -> None:
        """Resolve futures off the dispatch thread: wait here for each
        batch's event, never for the whole device."""
        while True:
            entry = self._inflight.get()
            if entry is None:
                return
            host, done, sinks = entry
            with span("engine.drain"):
                try:
                    if done is not None:
                        done.synchronize()
                    out = _materialize_local_rows(host)
                    off = 0
                    for fut, n in sinks:
                        fut.set_result(out[off] if n == 1 else out[off:off + n])
                        off += n
                except Exception as exc:  # handed to the batch's futures
                    for fut, _ in sinks:
                        if not fut.done():
                            fut.set_exception(exc)

    def _follow(self) -> None:
        """A follower's loop: the leader's batches, each through the same
        forward (its collectives meet the leader's) under the leader's
        precision switches, until the leader stops; a wait longer than
        ``_FOLLOW_TIMEOUT_S`` fails it."""
        from .tensor_parallel import broadcast

        device_ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
                      else contextlib.nullcontext())
        try:
            with torch.inference_mode(), device_ctx:
                hdr = torch.zeros(_HEADER, dtype=torch.int64)
                while True:
                    broadcast(hdr, self._group, self._leader, _FOLLOW_TIMEOUT_S)
                    kind, n, ndim = (int(v) for v in hdr[:3])
                    if kind == _STOP:
                        return
                    if kind == _KEEPALIVE:
                        continue
                    shape = tuple(int(d) for d in hdr[3:3 + ndim])
                    buf = torch.empty(shape, dtype=self._in_dtype,
                                      pin_memory=self.device.type == "cuda")
                    t0 = time.perf_counter()
                    broadcast(buf, self._group, self._leader, _FOLLOW_TIMEOUT_S)
                    self.broadcast_s += time.perf_counter() - t0
                    self.broadcast_bytes += hdr.nbytes + buf.nbytes
                    code = int(hdr[_HEADER - 1])
                    same = code == _switches_code(precision.packed_settings()[1:])
                    with contextlib.nullcontext() if same else _switches(code):
                        self._forward(buf.to(self.device, non_blocking=True))
                    self.n_processed += n
                    self.n_batches += 1
        except Exception as exc:  # raised again by stop()
            self.error = exc
