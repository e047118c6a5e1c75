#!/usr/bin/env python3
"""What the port's spans (``quantize_tpu_torch.profiling.span``) cost on the
card, and where their ranges fall on the device trace's timeline.

    python3 scripts/span_cost.py [--out chiprun_out/span_cost] [--rounds 4]

On the benchmark's configurations (``benchmark/configs``: ResNet-50 W8A8 at
256, ViT-B/16 W4A8 at 128, and a ViT-B/16 W4A8 QAT step of 64), from seeded
weights:

* host ms a packed forward, queued two ahead as the offline cells queue them
  (the synchronize outside the timed call), and host ms a QAT step (it reads
  its loss back, so a step's host time is its time), three ways in turns:
  ``off`` no profiler (every span only reads the flag), ``on`` under
  ``torch.profiler`` with the spans open, ``held`` under the profiler with
  the spans held off (the flag hidden from them alone); and the spans'
  own cost, on and held off call by call inside one profiler session;
* one packed ResNet-50 forward under ``profiling.trace``: each of the port's
  kernels is matched through its launch's correlation id to the innermost
  ``qtt.op.*`` range around that launch on the host;
* four QAT steps under ``profiling.trace``: the card's idle gaps, each
  labelled by the innermost ``qtt.*`` range on the host where it begins, and
  the steps' span totals.

Prints one JSON line a measurement; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.core import inputs, program  # noqa: E402
from benchmark.core.trace import _is_device, _union  # noqa: E402
from benchmark.drivers import qat_steps  # noqa: E402

# the port's kernel symbols (quantize_tpu_torch/csrc), as the benchmark's
# torch_pass_ms.infer reader lists them
_spec = importlib.util.spec_from_file_location(
    "torch_pass_reader", ROOT / "benchmark" / "metrics" / "torch_pass_ms.infer.py")
_reader = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_reader)
PORT_KERNELS = _reader.PORT
MODES = ("off", "on", "held", "held", "on", "off")


def config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


class _Held:
    """The profiler flag as the spans read it, hidden from them alone."""

    _is_profiler_enabled = False


def timed(mode: str, fn, calls: int) -> list:
    """Host seconds of each of ``calls`` calls of ``fn`` in ``mode``."""
    from quantize_tpu_torch import profiling

    real = profiling._autograd_profiler
    times = []
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                               torch.profiler.ProfilerActivity.CUDA])
            if mode != "off" else None)
    if prof is not None:
        prof.__enter__()
    if mode == "held":
        profiling._autograd_profiler = _Held
    try:
        for _ in range(calls):
            times.append(fn())
    finally:
        profiling._autograd_profiler = real
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
    return times


def forward_cost(qtt, name: str, batch: int, seed: int, rounds: int, calls: int) -> dict:
    cfg = config(name)
    dev = torch.device("cuda", 0)
    with program.switches(qtt, cfg), torch.inference_mode():
        model = program.packed_from_seed(qtt, cfg, seed, dev)
        xs = inputs.batches(cfg, seed, 2, batch, dev)
        state = {"i": 0, "ev": []}

        def one():
            x = xs[state["i"] % 2]
            state["i"] += 1
            t0 = time.perf_counter()
            model(x, mode="packed")
            t = time.perf_counter() - t0
            ev = torch.cuda.Event()
            ev.record()
            state["ev"].append(ev)
            if len(state["ev"]) > 2:
                state["ev"].pop(0).synchronize()
            return t

        for _ in range(4):
            one()
        torch.cuda.synchronize()
        out = {m: [] for m in MODES}
        for _ in range(rounds):
            for mode in MODES:
                out[mode] += timed(mode, one, calls)
        ms = {m: 1e3 * statistics.median(v) for m, v in out.items()}
        ms["on_minus_held_paired"] = paired(one, 24 * calls)
    return ms


def paired(fn, calls: int) -> float:
    """Median host ms a call that the spans add under one profiler session,
    the spans open and held off in turns (on, held, held, on, ...) call by
    call."""
    from quantize_tpu_torch import profiling

    real = profiling._autograd_profiler
    diffs = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        try:
            for i in range(calls // 2):
                first_on = i % 2 == 0
                t = {}
                for on in (first_on, not first_on):
                    profiling._autograd_profiler = real if on else _Held
                    t[on] = fn()
                diffs.append(t[True] - t[False])
        finally:
            profiling._autograd_profiler = real
            torch.cuda.synchronize()
    return 1e3 * statistics.median(diffs)


def step_cost(qtt, seed: int, rounds: int, calls: int, out_dir: str) -> dict:
    cfg = config("vit_b16_w4a8")
    t = json.loads((ROOT / "benchmark" / "traffic" / "qat_b64.json").read_text())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    calib, batches = qat_steps.data(cfg, t, seed, dev)
    runner = qat_steps.build_runner(qtt, cfg, t, out_dir, dev)
    qat_steps.first_steps(qtt, types.SimpleNamespace(seed=seed, device=dev), runner, cfg, t,
                          calib, batches)
    state = {"i": 0}

    def one():
        t0 = time.perf_counter()
        runner.train_step(batches[state["i"] % len(batches)], 1, 0, 1)
        state["i"] += 1
        return time.perf_counter() - t0

    out = {m: [] for m in MODES}
    for _ in range(rounds):
        for mode in MODES:
            out[mode] += timed(mode, one, calls)
    return {m: 1e3 * statistics.median(v) for m, v in out.items()}, gaps(one, out_dir)


def gaps(step, out_dir: str, steps: int = 4) -> dict:
    """The card's idle time over ``steps`` steps under ``profiling.trace``,
    by the innermost ``qtt.*`` range where each gap begins."""
    from quantize_tpu_torch import profiling

    with profiling.trace(os.path.join(out_dir, "qat_trace")) as prof:
        for _ in range(steps):
            step()
    events = prof.events()
    busy = _union([(e.time_range.start, e.time_range.end) for e in events if _is_device(e)])
    if not busy:
        return {"steps": steps, "spans": profiling.span_totals()}
    ranges = [e for e in events if e.name.startswith("qtt.")]
    found, at = [], busy[0][1]
    for a, b in busy[1:]:
        if a > at:
            cover = [e for e in ranges if e.time_range.start <= at <= e.time_range.end]
            label = max(cover, key=lambda e: e.time_range.start).name if cover else "none"
            found.append((label, (a - at) / 1e3))
        at = max(at, b)
    by_label = {}
    for label, ms in found:
        by_label[label] = by_label.get(label, 0.0) + ms
    window_ms = (busy[-1][1] - busy[0][0]) / 1e3
    return {"steps": steps, "window_ms": window_ms, "idle_ms_by_range": by_label,
            "longest": sorted(found, key=lambda g: -g[1])[:10],
            "spans": profiling.span_totals()}


def trace_check(qtt, seed: int, out_dir: str) -> dict:
    """The port's kernels of one packed ResNet-50 forward, each matched to
    the innermost ``qtt.op.*`` range around its launch."""
    from quantize_tpu_torch import profiling

    cfg = config("resnet50_w8a8")
    dev = torch.device("cuda", 0)
    with program.switches(qtt, cfg), torch.inference_mode():
        model = program.packed_from_seed(qtt, cfg, seed, dev)
        x = inputs.batches(cfg, seed, 1, 256, dev)[0]
        model(x, mode="packed")
        torch.cuda.synchronize()
        with profiling.trace(out_dir):
            model(x, mode="packed")
    events = json.loads((Path(out_dir) / profiling.TRACE_FILE).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"
             and str(e.get("name", "")).startswith("qtt.op.")]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    by_op, outside = {}, []
    for k in kernels:
        if not PORT_KERNELS(k["name"]):
            continue
        launch = launches.get(k.get("args", {}).get("correlation"))
        cover = [] if launch is None else [
            s for s in spans if s["tid"] == launch["tid"]
            and s["ts"] <= launch["ts"] and launch["ts"] + launch["dur"] <= s["ts"] + s["dur"]]
        if not cover:
            outside.append(k["name"][:80])
            continue
        op = max(cover, key=lambda s: s["ts"])["name"]
        key = f"{op} <- {k['name'][:60]}"
        by_op[key] = by_op.get(key, 0) + 1
    return {"port_kernels": sum(by_op.values()) + len(outside),
            "inside_an_op_span": sum(by_op.values()), "outside": outside[:10], "by_op": by_op,
            "op_spans": len(spans),
            "kernel_after_its_launch": all(
                k["ts"] >= launches[k["args"]["correlation"]]["ts"] for k in kernels
                if k.get("args", {}).get("correlation") in launches),
            "spans": profiling.span_totals()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "span_cost"))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 29)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("span_cost.py needs a CUDA device", file=sys.stderr)
        return 3
    qtt = program.port()
    program.build_kernels(qtt, torch.device("cuda", 0))
    card = torch.cuda.get_device_name(0)
    print(json.dumps({"trace": trace_check(qtt, args.seed, os.path.join(args.out, "trace")),
                      "card": card}), flush=True)
    for name, batch in (("resnet50_w8a8", 256), ("vit_b16_w4a8", 128)):
        ms = forward_cost(qtt, name, batch, args.seed, args.rounds, 8)
        print(json.dumps({"host_ms_a_forward": name, "batch": batch, **ms, "card": card}),
              flush=True)
        torch.cuda.empty_cache()
    ms, idle = step_cost(qtt, args.seed, max(1, args.rounds // 2), 3, args.out)
    print(json.dumps({"host_ms_a_step": "vit_b16_w4a8.qat_b64", **ms, "card": card}), flush=True)
    print(json.dumps({"qat_idle": idle, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
