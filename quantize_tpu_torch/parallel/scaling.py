"""1 -> N scaling measurement of packed inference.

PyTorch counterpart of ``quantize_tpu/parallel/scaling.py``: the step time of
the packed forward on one device and on a ``(dp, tp)`` mesh of ranks
(:func:`measure_scaling`), in one process or across fresh interpreters over
``torch.distributed`` (:func:`run_multiprocess_scaling`), with the
collectives of a step. JAX reads them from the compiled HLO
(:func:`collective_stats`, kept for HLO text); the port counts them where
its own collective wrappers run (:class:`CollectiveCounter`): ops, bytes of
their results, the bytes staged through pinned host memory and their time
(CUDA events on the card, the host clock on the CPU). JAX's ``est_ici_ms``,
an estimate for a TPU's links, has no counterpart.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# async collectives appear as <op>-start / <op>-done pairs in optimized
# HLO; the suffix is captured and '-done' lines are skipped. The result
# type (everything between '=' and the op name) may be a tuple, so every
# dtype[dims] group in it is parsed.
_COLLECTIVE_RE = re.compile(
    r"=\s*([^=]*?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all)"
    r"(-start|-done)?\("
)

_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([\d,]*)\]")

_DTYPE_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "s8": 1, "u8": 1, "s4": 0.5, "u4": 0.5, "pred": 1,
                "f64": 8, "s64": 8, "s16": 2, "u16": 2, "f8": 1,
                "c64": 8, "c128": 16}


def collective_stats(hlo_text: str) -> Dict[str, Any]:
    """Count the collectives and their payload bytes in an optimized HLO
    module's text (JAX's parser; its ``est_ici_ms`` left out).

    A tuple-shaped async start whose result is the duplicated in/out alias
    pattern ``(X..., X...)`` counts its payload once; any other structure
    counts every element. Unrecognized dtypes count 4 bytes and are listed
    in ``unknown_dtypes``."""
    counts: Dict[str, int] = {}
    total_bytes = 0.0
    unknown = set()
    for m in _COLLECTIVE_RE.finditer(hlo_text):
        result_type, op, suffix = m.group(1), m.group(2), m.group(3)
        if suffix == "-done":
            continue  # the matching -start already counted this collective
        counts[op] = counts.get(op, 0) + 1
        shapes = _SHAPE_RE.findall(result_type)
        half = len(shapes) // 2
        if (suffix == "-start" and len(shapes) % 2 == 0 and half
                and shapes[:half] == shapes[half:]):
            shapes = shapes[:half]  # (operand alias, result) duplication
        for dtype, dims in shapes:
            n = 1
            for d in dims.split(","):
                if d.strip().isdigit():
                    n *= int(d)
            if dtype not in _DTYPE_BYTES:
                unknown.add(dtype)
            total_bytes += n * _DTYPE_BYTES.get(dtype, 4)
    out: Dict[str, Any] = {"collective_counts": counts, "collective_bytes_per_step": total_bytes}
    if unknown:
        out["unknown_dtypes"] = sorted(unknown)
    return out


_ACTIVE: List["CollectiveCounter"] = []


def record_collective(op: str, nbytes: int, staged: int, events=None, seconds: float = 0.0) -> None:
    """Report one collective to every active :class:`CollectiveCounter`:
    ``nbytes`` of result, ``staged`` bytes copied between the card and
    pinned host memory, and its time as a pair of recorded CUDA events or
    host ``seconds``."""
    for counter in _ACTIVE:
        counter.counts[op] = counter.counts.get(op, 0) + 1
        counter.nbytes += nbytes
        counter.staged_bytes += staged
        counter.seconds += seconds
        if events is not None:
            counter.events.append(events)


class CollectiveCounter:
    """A context that counts the collectives the port's wrappers run inside
    it (:func:`~.tensor_parallel.all_gather`), on any thread."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.nbytes = 0
        self.staged_bytes = 0
        self.seconds = 0.0
        self.events: List[tuple] = []

    def __enter__(self) -> "CollectiveCounter":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    @property
    def ms(self) -> float:
        """Time in the collectives: each one's CUDA events (waits for them)
        plus the host time of those that ran on the CPU."""
        if self.events:
            self.events[-1][1].synchronize()
        return 1e3 * self.seconds + sum(a.elapsed_time(b) for a, b in self.events)

    def per_step(self, steps: int) -> Dict[str, Any]:
        """JAX's keys (``collective_counts``, ``collective_bytes_per_step``)
        and the port's (``collective_ms``, ``staged_bytes_per_step``), each
        a step of ``steps``."""
        return {"collective_counts": {op: n // steps for op, n in self.counts.items()},
                "collective_bytes_per_step": self.nbytes / steps,
                "collective_ms": self.ms / steps,
                "staged_bytes_per_step": self.staged_bytes / steps}


def _time_steps(fn, x: torch.Tensor, iters: int, warmup: int = 2, fetch=None) -> float:
    """Seconds a step, with chained inputs (each step's input moves by a
    function of the last output, so no two steps see the same input) and
    a wait for the device after each step (``fetch``)."""
    if fetch is None:
        dev = x.device
        fetch = (lambda out: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (
            lambda out: None)
    seed = torch.zeros((), dtype=torch.float32, device=x.device)

    def step(sd):
        out = fn(x + sd)  # distinct input each call: no caching
        return sd + 1e-3 * torch.tanh(out.float().mean()), out

    for _ in range(warmup):
        seed, out = step(seed)
        fetch(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        seed, out = step(seed)
        fetch(out)
    return (time.perf_counter() - t0) / iters


def _launch_census() -> Dict[str, int]:
    """Kernel launches since the last reset, by wrapper and by route
    (``<wrapper>.<route>``)."""
    from ..ops import KERNEL_WRAPPERS, launch_counts

    out = launch_counts()
    for name, fn in KERNEL_WRAPPERS.items():
        for route, n in getattr(fn, "route_launches", {}).items():
            out[f"{name}.{route}"] = n
    return out


def _world() -> tuple:
    return (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)


def measure_scaling(
    model_name: str = "resnet50",
    w_bits: int = 8,
    per_device_batch: int = 8,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    image_size: int = 64,
    num_classes: int = 100,
    iters: int = 5,
    device="cuda",
) -> Dict[str, Any]:
    """Measure packed-inference scaling on a ``(dp, tp)`` mesh against one
    device (JAX's record; weak scaling: the per-device batch is constant,
    ``efficiency = t1 / tN``).

    In one process the mesh is of one device. Under ``torch.distributed``
    every rank calls this, the mesh spans the ``dp * tp`` ranks (default
    ``(2, N / 2)``, else ``(1, N)``), rank ``r`` on ``cuda:(r %
    device_count())`` (or the CPU with ``device="cpu"``), and each builds
    the same seeded model and takes rank 0's deploy variables. ``t1`` is
    each rank's own forward on one device. Beyond JAX's keys:
    ``n_processes``, ``ranks_per_device``, the collectives' time and staged
    bytes a step, each rank's sharded output against its rows of the
    one-device forward of the global batch, over every rank
    (``max_abs_err_vs_1dev``, ``n_differ_vs_1dev``), and the kernel
    launches of that one-device forward and of one sharded forward, by
    wrapper and route (``launches_1dev``, ``launches_ndev``)."""
    from ..api import calibrate_model, init_model
    from ..convert import from_jax_variables
    from ..deploy import pack_model
    from ..models import MODELS
    from ..nn.intercept import QuantCtx
    from ..ops import reset_launch_counts
    from .mesh import make_mesh, shard_batch, shard_variables

    rank, world = _world()
    if dp is None and tp is None:
        dp, tp = (2, world // 2) if world % 2 == 0 and world > 1 else (1, world)
    dp, tp = dp or 1, tp or 1
    n_used = dp * tp
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("measure_scaling runs on CUDA, and torch sees no CUDA device; "
                               "pass device='cpu' to measure on the CPU")
        count = torch.cuda.device_count()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devices = ([dev] if n_used == 1
                   else [torch.device("cuda", r % count) for r in range(n_used)])
    else:
        devices = [dev] * n_used
    mesh = make_mesh(dp, tp, devices=devices)
    local = mesh.device
    cuda = local.type == "cuda"
    if cuda:
        torch.cuda.set_device(local)
    sync = (lambda: torch.cuda.synchronize(local)) if cuda else (lambda: None)

    cfg = {"default": {
        "weight": {"n_bits": w_bits, "symmetric": True, "signed": True,
                   "granularity": "channel", "range": {"name": "minmax"}},
        "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                       "range": {"name": "minmax"}},
        "bn_folding": True}}
    model = MODELS.build(model_name, num_classes=num_classes, ctx=QuantCtx(cfg), device=local)
    rng = np.random.default_rng(0)
    x1_np = rng.normal(size=(per_device_batch, image_size, image_size, 3)).astype(np.float32)
    init_model(model, x1_np, seed=0, device=local)
    calibrate_model(model, [x1_np], device=local)
    deploy = pack_model(model, x1_np, device=local)
    if world > 1:
        from .tensor_parallel import broadcast_variables

        deploy = broadcast_variables(deploy)
        from_jax_variables(model, deploy)

    def fn(x):
        with torch.inference_mode():
            return model(x, mode="packed")

    # -- 1-device baseline (same per-device batch) ------------------------
    x1 = torch.from_numpy(x1_np).to(local)
    t1 = _time_steps(fn, x1, iters)

    # -- this rank's rows, and the one-device forward of the global batch
    # every process makes the whole seeded batch and keeps its rows
    xg_np = rng.normal(size=(per_device_batch * dp, image_size, image_size, 3)).astype(np.float32)
    xg = shard_batch(mesh, {"img": xg_np})["img"]
    reset_launch_counts()
    rows = slice(mesh.coords[0] * per_device_batch, (mesh.coords[0] + 1) * per_device_batch)
    ref = fn(torch.from_numpy(xg_np).to(local))[rows]
    sync()
    launches_1dev = _launch_census()

    # -- the sharded run -------------------------------------------------
    from_jax_variables(model, shard_variables(mesh, deploy))
    reset_launch_counts()
    out = fn(xg)
    sync()
    launches_ndev = _launch_census()
    err = torch.stack([(out.float() - ref.float()).abs().max(),
                       (out != ref).sum().float()]).cpu()
    if world > 1:
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
    warmup = 2
    with CollectiveCounter() as counter:
        tn = _time_steps(fn, xg, iters, warmup=warmup)
    collectives = counter.per_step(warmup + iters)

    global_batch = per_device_batch * dp
    return {
        "model": model_name, "w_bits": w_bits,
        "mesh": {"data": dp, "model": tp}, "n_devices": n_used,
        "n_processes": world,
        "ranks_per_device": sum(d == local for d in mesh.devices.flat),
        "platform": "gpu" if cuda else "cpu",
        "per_device_batch": per_device_batch, "global_batch": global_batch,
        "image_size": image_size,
        "t1_ms": t1 * 1e3, "tn_ms": tn * 1e3,
        "img_per_s_per_chip_1dev": per_device_batch / t1,
        "img_per_s_per_chip_ndev": global_batch / tn / n_used,
        "weak_scaling_efficiency": t1 / tn,
        **collectives,
        "max_abs_err_vs_1dev": float(err[0]),
        "n_differ_vs_1dev": int(err[1]),
        "launches_1dev": launches_1dev,
        "launches_ndev": launches_ndev,
    }


def _worker_main() -> None:
    """One rank of :func:`run_multiprocess_scaling`:
    ``<rank> <world> <port> <measure_scaling keywords as JSON>``."""
    from .mesh import init_distributed

    from ..nn import precision

    rank, world, port = (int(a) for a in sys.argv[1:4])
    kwargs = json.loads(sys.argv[4])
    carry, fused, qin = kwargs.pop("precision")
    precision.set_packed_carry_dtype(getattr(torch, carry))
    precision.set_packed_fused_residual(fused)
    precision.set_packed_qin_carry(qin)
    init_distributed(rank, world, port)
    try:
        record = measure_scaling(**kwargs)
    finally:
        dist.destroy_process_group()
    print(("MPSCALING " + json.dumps(record)) if rank == 0 else "MPOK", flush=True)


_WORKER = "from quantize_tpu_torch.parallel.scaling import _worker_main; _worker_main()"
# after a worker fails, how long the others may take to end on their own
FAIL_GRACE_S = 5.0


def spawn_ranks(n_processes: int, script: str, args: List[str] = (), timeout: float = 420.0,
                port: Optional[int] = None, threads: Optional[int] = None) -> List[str]:
    """Run ``python -c script <rank> <n_processes> <port> *args`` in
    ``n_processes`` fresh interpreters (never a fork of this one, whose CUDA
    state a child cannot reuse), this repository on their path, and return
    each one's output (stdout and stderr). ``port`` (default: a free one)
    is for the ranks' ``tcp://127.0.0.1`` store (:func:`~.mesh.init_distributed`);
    ``threads`` sets their ``OMP_NUM_THREADS``. Once a worker fails, the
    others have ``FAIL_GRACE_S`` to end; then every worker still running,
    or one that outlives ``timeout`` seconds, is killed, and the
    RuntimeError carries the last 3,000 characters of the output of the
    lowest failing rank (or of the first one killed)."""
    from .mesh import free_port

    port = free_port() if port is None else port
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    # every rank is on this host: gloo's pairs connect over loopback
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    with tempfile.TemporaryDirectory() as td:
        logs = [open(os.path.join(td, f"rank{i}.log"), "w+") for i in range(n_processes)]
        procs = [subprocess.Popen([sys.executable, "-c", script, str(i), str(n_processes),
                                   str(port), *args],
                                  stdout=logs[i], stderr=subprocess.STDOUT, env=env)
                 for i in range(n_processes)]
        deadline = time.monotonic() + timeout
        killed = []
        try:
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if any(c not in (None, 0) for c in codes):
                    # the others a few seconds to fail too, so that the error
                    # names the lowest failing rank whatever the order
                    deadline = min(deadline, time.monotonic() + FAIL_GRACE_S)
                    while time.monotonic() < deadline and any(p.poll() is None for p in procs):
                        time.sleep(0.05)
                    break
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.05)
        finally:
            # a hung or failed worker must not outlive the call (nor hold
            # the port, nor wait forever in a collective for a dead peer)
            for i, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
                    killed.append(i)
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    failed = [i for i, p in enumerate(procs) if p.returncode != 0 and i not in killed]
    if failed:
        i = failed[0]
        raise RuntimeError(f"worker {i} of {n_processes} failed (exit {procs[i].returncode}):\n"
                           f"{outs[i][-3000:]}")
    if killed:
        raise RuntimeError(f"workers {killed} of {n_processes} did not finish within {timeout} "
                           f"s:\n{outs[killed[0]][-3000:]}")
    return outs


def run_multiprocess_scaling(
    n_processes: int = 2,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    model_name: str = "resnet18",
    w_bits: int = 8,
    per_device_batch: int = 2,
    image_size: int = 32,
    iters: int = 2,
    num_classes: int = 16,
    port: Optional[int] = None,
    timeout: float = 420.0,
    device="cuda",
) -> Dict[str, Any]:
    """Run :func:`measure_scaling` across a process boundary: one rank in
    each of ``n_processes`` fresh interpreters (:func:`spawn_ranks`), joined
    over gloo, on a ``(dp, tp)`` mesh (default ``(n_processes, 1)``),
    under this process's packed precision switches (the carry dtype, the
    fused residual tail, the int8 carry). On CUDA the kernels are built
    here first, so that the ranks load them; on the CPU the ranks share the
    cores. Returns rank 0's record."""
    if dp is None:
        dp = n_processes // (tp or 1)
    tp = tp if tp is not None else n_processes // dp
    if dp * tp != n_processes:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} processes, not {n_processes}")
    threads = None
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_multiprocess_scaling runs on CUDA, and torch sees no CUDA "
                               "device; pass device='cpu' to run on the CPU")
        from ..ops import _build

        _build.build_all()
    else:
        threads = max(1, (os.cpu_count() or 1) // n_processes)
    from ..nn import precision

    _, carry, fused, qin = precision.packed_settings()
    kwargs = dict(model_name=model_name, w_bits=w_bits, per_device_batch=per_device_batch,
                  dp=dp, tp=tp, image_size=image_size, num_classes=num_classes, iters=iters,
                  device=str(device), precision=(str(carry).replace("torch.", ""), fused, qin))
    outs = spawn_ranks(n_processes, _WORKER, [json.dumps(kwargs)], timeout, port, threads)
    line = next((ln for ln in outs[0].splitlines() if ln.startswith("MPSCALING ")), None)
    if line is None:
        raise RuntimeError(f"multiprocess scaling worker 0 printed no record:\n{outs[0][-3000:]}")
    return json.loads(line[len("MPSCALING "):])
