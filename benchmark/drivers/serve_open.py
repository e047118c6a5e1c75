"""Traffic kind ``serve_open``: independent clients, open loop, through the
serving engine.

Requests of ``min_images``..``max_images`` uint8 images (uniform) arrive on
the schedule of :func:`~benchmark.core.inputs.schedule` at
``rate_img_per_s``, whether or not earlier ones are done; the one producer
thread sends each with ``InferenceEngine.submit_many`` when it is due. The
engine (``batch``, ``max_wait_ms``, ``max_in_flight``) stages them into
pinned memory, normalizes on the device and returns logits. A request's
latency runs from when it was due to when its last image's future resolved;
one that fails, or is unresolved ``grace_s`` after the window, counts as
missing, with the latency of that wait. ``latency_p95_ms`` is the 95th
percentile over every request of the window.

The images come from a pool of ``pool`` distinct seeded images (a request
takes ``n`` consecutive ones from an offset drawn from the seed). After the
window, ``compare_requests`` finished requests drawn from the seed (and the
largest finished one) are compared with the reference. A traced run
profiles from ``trace_from`` of the window until every request is done.
"""
from __future__ import annotations

import concurrent.futures
import statistics
import sys
import time

import numpy as np
import torch

from ..core import check, inputs, program
from ..core.spec import sub_seed
from ..core.trace import Stretch, span


def run(r) -> dict:
    cfg, dev, qtt = r.cell.config, r.device, r.qtt
    build_s = program.build_kernels(qtt, dev)
    with program.switches(qtt, cfg):
        return _window(r, program.packed_from_seed(qtt, cfg, r.seed, dev), build_s)


def normalizer(dev):
    """The engine's on-device preprocess: ImageNet's normalize of x / 255."""
    shift = torch.tensor([255.0 * m for m in inputs.IMAGENET_MEAN], device=dev)
    scale = torch.tensor([255.0 * s for s in inputs.IMAGENET_STD], device=dev)
    return lambda x: (x.float() - shift) / scale


def start_engine(model, t: dict, pool: np.ndarray, dev, sync):
    """The engine over ``model``, started, with its serving shape warmed: a
    direct forward at its batch, then as many full batches at once as the
    engine holds staged and in flight (its pinned host buffers made), then a
    partial batch."""
    from quantize_tpu_torch.parallel import InferenceEngine

    batch, pre = int(t["batch"]), normalizer(dev)
    with torch.inference_mode():
        x = torch.from_numpy(pool[:batch]).to(dev)
        for _ in range(2):
            model(pre(x), mode="packed")
        sync()
    eng = InferenceEngine(model, batch_size=batch, max_wait_ms=float(t["max_wait_ms"]),
                          max_in_flight=int(t["max_in_flight"]), input_dtype=np.uint8,
                          preprocess=pre, device=dev)
    eng.start()
    burst = [f for _ in range(int(t["max_in_flight"]) + 4) for f in eng.submit_many(pool[:batch])]
    for f in burst + eng.submit_many(pool[:batch // 2 + 1]):
        f.result(timeout=600)
    return eng


def offer(eng, pool, due, sizes, offsets, seconds: float, grace_s: float, trace: bool = False,
          stretch=None, trace_from: float = 1.0) -> dict:
    """Send each request when it is due; wait until all are done or
    ``grace_s`` after the window. Returns the requests' futures, latencies
    (ms) and missing count, the generator's lateness and the engine's
    counters over the window."""
    n_req = len(due)
    last_done = [None] * n_req
    futs = []

    def resolved(i):
        def cb(_f):
            last_done[i] = time.perf_counter()
        return cb

    late = []
    before = eng.stats()
    t0 = time.perf_counter() + 0.01
    traced_at = None
    for i in range(n_req):
        when = t0 + due[i]
        wait = when - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if (stretch is not None and traced_at is None
                and time.perf_counter() - t0 >= seconds * trace_from):
            stretch.start()
            traced_at = eng.stats()["batches"]
        late.append(time.perf_counter() - when)
        with span("submit", trace):
            fs = eng.submit_many(pool[offsets[i]:offsets[i] + sizes[i]])
        # a request's images resolve in order: its last one resolves last
        fs[-1].add_done_callback(resolved(i))
        futs.append(fs)
    t_last = time.perf_counter()
    with span("drain", trace):
        concurrent.futures.wait([f for fs in futs for f in fs],
                                timeout=max(0.0, t0 + seconds + grace_s - time.perf_counter()))
    t_end = time.perf_counter()
    after = eng.stats()
    if traced_at is not None:
        stretch.stop(after["batches"] - traced_at)
    lat, missing, finished = [], 0, []
    for i, fs in enumerate(futs):
        ok = last_done[i] is not None and all(f.done() and f.exception() is None for f in fs)
        missing += not ok
        if ok:
            finished.append(i)
        lat.append(((last_done[i] if ok else t_end) - (t0 + due[i])) * 1e3)
    batches = after["batches"] - before["batches"]
    per = max(batches, 1)
    engine = {
        "dispatch_ms": (after["dispatch_ms"] * after["batches"]
                        - before["dispatch_ms"] * before["batches"]) / per,
        "staging_ms": (after["staging_ms"] * after["batches"]
                       - before["staging_ms"] * before["batches"]) / per,
        "fill": (after["processed"] - before["processed"]) / per / eng.batch_size,
        "batches": batches, "failed": after["failed"] - before["failed"],
    }
    return {"futs": futs, "lat": lat, "missing": missing, "finished": finished, "late": late,
            "engine": engine, "loop_over_s": t_last - t0 - seconds}


def p95(lat) -> float:
    return statistics.quantiles(lat, n=100, method="inclusive")[94] if len(lat) > 1 else lat[0]


def _window(r, model, build_s) -> dict:
    cfg, t, dev = r.cell.config, r.cell.traffic, r.device
    seconds = float(r.seconds)
    pool = inputs.pool(cfg, r.seed, int(t["pool"]), dev).numpy()
    due, sizes = inputs.schedule(t, seconds, r.seed)
    gen = torch.Generator().manual_seed(sub_seed(r.seed, "offsets"))
    offsets = torch.randint(0, len(pool) - int(t["max_images"]) + 1, (len(due),),
                            generator=gen).tolist()
    eng = start_engine(model, t, pool, dev, r.sync)
    try:
        stretch = Stretch(dev) if r.trace else None
        if stretch is not None:
            stretch.warm(lambda: [f.result(timeout=600) for f in eng.submit_many(pool[:8])])
        r.reset_peak()
        r.begin_window()
        o = offer(eng, pool, due, sizes, offsets, seconds, float(t["grace_s"]), r.trace, stretch,
                  float(t["trace_from"]))
        r.read_peak()
    finally:
        eng.stop()
    lat, late = o["lat"], o["late"]
    print(f"serve_open: {len(due)} requests, {sum(sizes)} images over {seconds} s; generator "
          f"late p50 {statistics.median(late) * 1e3:.3f} ms, max {max(late) * 1e3:.3f} ms; "
          f"last request sent {o['loop_over_s'] * 1e3:.1f} ms after the window; latency p50 "
          f"{statistics.median(lat):.3f} ms, p95 {p95(lat):.3f} ms, max {max(lat):.3f} ms; "
          f"engine {o['engine']}", file=sys.stderr)
    del model, eng
    r.free()

    # the comparison, on finished requests drawn from the seed, and the largest
    finished, futs = o["finished"], o["futs"]
    pick = []
    if finished:
        order = torch.randperm(len(finished), generator=gen)[:int(t["compare_requests"])]
        pick = sorted({finished[j] for j in order.tolist()}
                      | {max(finished, key=lambda i: sizes[i])})
    ref = check.reference(cfg, inputs.state_dict(cfg, r.seed, dev),
                          inputs.calibration(cfg, r.seed, dev))
    gaps = []
    with torch.inference_mode():
        for i in pick:
            imgs = torch.from_numpy(pool[offsets[i]:offsets[i] + sizes[i]]).to(dev)
            got = torch.from_numpy(np.stack([f.result() for f in futs[i]])).to(dev)
            gaps.append(check.row_gap(got, ref.forward(inputs.normalize(imgs))))
    compared = {"logit_row_gap": max(gaps) if gaps else float("inf")}
    return {"e2e": {"latency_p95_ms": p95(lat), "setup_s": r.setup_s},
            "attempted": len(due), "failed": o["missing"], "compared": compared,
            "stretch": None if stretch is None else stretch.summary, "engine": o["engine"],
            "info": {"requests": len(due), "images": sum(sizes), "build_s": build_s,
                     "compared_requests": len(pick), "late_max_ms": max(late) * 1e3,
                     "p50_ms": statistics.median(lat), "max_ms": max(lat),
                     # a backlog that grows over the window shows as later
                     # requests waiting longer (lat is in the order of due)
                     "first_half_p50_ms": statistics.median(lat[:max(1, len(lat) // 2)]),
                     "last_tenth_p50_ms": statistics.median(lat[-max(1, len(lat) // 10):]),
                     **{f"engine_{k}": v for k, v in o["engine"].items()}}}
