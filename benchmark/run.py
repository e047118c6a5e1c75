#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``quantize_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. One run: set-up (the port's kernel libraries
built or found, seeded weights made on the card, imported, calibrated and
packed, every shape the cell's traffic uses warmed), then the window of
``--seconds``, then the comparison with the plain reference, then one JSON
line, the last of standard output:
``{"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "compared"}``.
With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (read from a traced stretch of the window
by the readers in ``benchmark/metrics/<name>.py``). Cells, configurations,
traffic mixes and readers are data found by name (``benchmark/core/spec.py``).

The run refuses (exit code 3, no result) without CUDA or with fewer cards
than the cell asks for, and (exit code 4, no result) if a module of JAX,
flax, optax or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# compared by whole top-level name: the port's own name begins with the last
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "quantize_tpu")
# build and kernel caches: fixed paths inside the checkout
CACHE = ROOT / ".bench_cache"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Run:
    """What a traffic kind's driver is handed: the cell, the seed, the window,
    the port, and the device's clock and memory."""

    def __init__(self, args, cell, device, qtt, t_start: float):
        import torch

        self.torch = torch
        self.cell, self.device, self.qtt, self.t_start = cell, device, qtt, t_start
        self.seed, self.seconds, self.trace = int(args.seed), float(args.seconds), bool(args.trace)
        self.cuda = device.type == "cuda"
        self.setup_s = None
        self.memory_peak_bytes = 0

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def event(self):
        if not self.cuda:
            return _Done()
        ev = self.torch.cuda.Event()
        ev.record()
        return ev

    def begin_window(self) -> None:
        """Set-up ends: its time is taken, and the objects it made are moved
        out of the garbage collector's scans (``gc.freeze``), so that a
        collection inside the window does not walk them."""
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_start

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def read_peak(self) -> None:
        if self.cuda:
            self.memory_peak_bytes = int(self.torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


class _Done:
    def synchronize(self) -> None:
        pass


def read_per_layer(cell, outcome: dict) -> dict:
    """Each per-layer metric of the cell from its reader
    (``benchmark/metrics/<name>.py``: ``read(cell, outcome)``, None where it
    finds nothing to read, and the metric is left out)."""
    out = {}
    for i, m in enumerate(cell.per_layer):
        path = ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{i}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(cell, outcome)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None, allow_cpu: bool = False, cell=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    from benchmark.core import check, spec

    cell = cell or spec.load_cell(args.workload)
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= cell.chips:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        print(f"refused: {args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from benchmark.core import program

    t_port = time.perf_counter()
    qtt = program.port()
    print(f"set-up s: to the port's import {t_port - T_START:.3f}, its import "
          f"{time.perf_counter() - t_port:.3f}", file=sys.stderr)
    r = Run(args, cell, device, qtt, T_START)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    outcome = driver.run(r)

    found = forbidden_modules()
    if found:
        print(f"refused: modules of {found} are loaded", file=sys.stderr)
        return 4
    limits = cell.params["limits"]
    compared = {k: (v if math.isfinite(v) else "inf") for k, v in outcome["compared"].items()}
    # a request that never came, or failed, makes the run not correct
    correct = (outcome["failed"] == 0 and all(isinstance(v, float) for v in compared.values())
               and check.judge(compared, limits))
    if args.trace:
        metrics = read_per_layer(cell, outcome)
    else:
        metrics = {m["name"]: {"value": float(outcome["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if r.cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if r.cuda else "cpu",
           "count": cell.chips if r.cuda else 0,
           "memory_peak_bytes": r.memory_peak_bytes}
    line = {"correct": bool(correct), "attempted": int(outcome["attempted"]),
            "failed": int(outcome["failed"]), "metrics": metrics, "device": dev}
    stretch = outcome.get("stretch")
    if args.trace and stretch is not None:
        dev["busy_s"], dev["window_s"] = stretch["busy_s"], stretch["window_s"]
        line["breakdown"] = stretch["breakdown"]
    print(f"info {check.dumps(outcome.get('info', {}))}", file=sys.stderr)
    line["compared"] = check.report(compared, limits)
    print(check.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
