"""Traffic kind ``offline``: packed batches dispatched ahead.

The window drives ``model(x, mode="packed")`` on batches of ``batch`` seeded
images (``distinct_batches`` of them, in turn), keeping at most ``depth``
forwards queued on the card ahead of the host: before the next forward is
queued, the host waits for the one ``depth`` back. The window ends in a
synchronize; ``img_per_s`` is every image of the window over its time.

A traced run profiles the window from ``trace_from`` of its length to its
end (the profiler's events are read after the window closes).

The outputs of every ``keep_every``-th forward (from an offset drawn from
the seed; at most ``keep_max``) are kept, and ``rows_per_kept`` rows of each,
drawn from the seed, are compared with the reference after the window.
"""
from __future__ import annotations

import collections
import time

import torch

from ..core import check, inputs, program
from ..core.spec import sub_seed
from ..core.trace import Stretch, span


def run(r) -> dict:
    cfg, traffic, dev = r.cell.config, r.cell.traffic, r.device
    batch, n_in = int(traffic["batch"]), int(traffic["distinct_batches"])
    depth, seconds = int(traffic["depth"]), float(r.seconds)
    qtt = r.qtt
    build_s = program.build_kernels(qtt, dev)
    with program.switches(qtt, cfg):
        # the model is only ever held by _window's frame, which frees it
        # before the reference runs
        return _window(r, program.packed_from_seed(qtt, cfg, r.seed, dev), cfg, traffic, dev,
                       batch, n_in, depth, seconds, build_s)


def _window(r, model, cfg, traffic, dev, batch, n_in, depth, seconds, build_s) -> dict:
    with torch.inference_mode():
        xs = inputs.batches(cfg, r.seed, n_in, batch, dev)

        def forward(x):
            return model(x, mode="packed")

        for x in xs:  # every shape the window runs, twice
            forward(x)
            forward(x)
        r.sync()
        stretch = Stretch(dev) if r.trace else None
        if stretch is not None:
            stretch.warm(lambda: forward(xs[0]))
        gen = torch.Generator().manual_seed(sub_seed(r.seed, "keep"))
        keep_every = int(traffic["keep_every"])
        offset = int(torch.randint(0, keep_every, (1,), generator=gen))
        kept = []
        r.reset_peak()
        queued = collections.deque()
        r.sync()
        r.begin_window()
        t0 = time.perf_counter()
        i, out = 0, None
        traced_from, last = None, t0
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            # from trace_from of the window, and at the latest on what looks
            # like its last forward
            if (stretch is not None and traced_from is None
                    and (now - t0 >= seconds * float(traffic["trace_from"])
                         or 2 * now - last - t0 >= seconds)):
                stretch.start()
                traced_from = i
            last = now
            with span("forward", r.trace):
                out = forward(xs[i % n_in])
            if i % keep_every == offset and len(kept) < int(traffic["keep_max"]):
                kept.append((i % n_in, out))
            queued.append(r.event())
            if len(queued) > depth:
                with span("sync", r.trace):
                    queued.popleft().synchronize()
            i += 1
        r.sync()
        t1 = time.perf_counter()
        if traced_from is not None:
            stretch.stop(i - traced_from)
        r.read_peak()
        window = t1 - t0
        del model, xs, queued, out
        r.free()

        # the reference, on the same weights, calibration batches and inputs
        rows = int(traffic["rows_per_kept"])
        ref = check.reference(cfg, inputs.state_dict(cfg, r.seed, dev),
                              inputs.calibration(cfg, r.seed, dev))
        xs = inputs.batches(cfg, r.seed, n_in, batch, dev)
        gaps = []
        for j, out in kept:
            idx = torch.randperm(batch, generator=gen)[:rows].to(dev)
            gaps.append(check.row_gap(out.index_select(0, idx), ref.forward(xs[j][idx])))
    compared = {"logit_row_gap": max(gaps) if gaps else float("inf")}
    return {"e2e": {"img_per_s": i * batch / window, "setup_s": r.setup_s},
            "attempted": i * batch, "failed": 0, "compared": compared,
            "stretch": None if stretch is None else stretch.summary,
            "info": {"forwards": i, "window_s": window, "build_s": build_s,
                     "compared_rows": rows * len(kept), "batch": batch}}
