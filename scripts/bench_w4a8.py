#!/usr/bin/env python3
"""Kernel K4 (W4A8 over split-half int4 weights) alone on one GPU, at the
shapes ViT-B/16 W4A8 gives it.

    python3 scripts/bench_w4a8.py [--batch 128] [--image 224] [--reps 7]

Random int8 activations and int4 weights from seed 0 at the four shapes of
a ViT-B/16 forward (the fused qkv, fc1 and fc2 at M = batch * S, S the
sequence padded to a multiple of 8, and the head at M = batch), each with
its K-major copy made beforehand as the model makes it. Prints one JSON
line a shape: the route taken, the per-launch CUDA-event median (``reps``
repeats of 20 launches), the bound max(2 M N K / 1,979 TOP/s, bytes moved
once / 3.35 TB/s) and its share, then a line with the sum over one forward
(12 launches of each projection, one head) and the card's name and power
limit. Needs a CUDA card and nvcc; compare two versions of the kernel only
within one machine, in turns.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--reps", type=int, default=7)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_w4a8: no CUDA device", file=sys.stderr)
        return 2
    from quantize_tpu_torch.ops.qmatmul import (kmajor_packed, pack_int4_splithalf, w4a8_gemm,
                                                w4a8_gemm_plain)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    seq = (opt.image // 16) ** 2 + 1
    m = opt.batch * (-(-seq // 8) * 8)
    shapes = [("qkv", m, 768, 2304, 12), ("fc1", m, 768, 3072, 12), ("fc2", m, 3072, 768, 12),
              ("head", opt.batch, 768, 1000, 1)]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    total = {"ms": 0.0, "bound_ms": 0.0}
    for name, mm, k, n, per_fwd in shapes:
        q = torch.randint(-128, 128, (mm, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
        w_p4 = pack_int4_splithalf(w)
        args = (q, torch.tensor(131.5, device=dev), torch.tensor(0.02, device=dev), w_p4,
                w.sum(0, dtype=torch.int32), torch.rand(n, generator=gen, device=dev) * 0.01,
                torch.zeros(n, device=dev), torch.randn(n, generator=gen, device=dev), True,
                kmajor_packed(w_p4))
        before = dict(w4a8_gemm.route_launches)
        got = w4a8_gemm(*args)
        if not torch.equal(got, w4a8_gemm_plain(*args)):
            print(f"bench_w4a8: {name} disagrees with the plain version", file=sys.stderr)
            return 1
        route = [r for r, c in w4a8_gemm.route_launches.items() if c != before[r]][0]
        for _ in range(3):
            w4a8_gemm(*args)
        times = []
        for _ in range(opt.reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                w4a8_gemm(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 20)
        ms = statistics.median(times)
        nbytes = mm * k + k * n // 2 + 4 * n * 4 + mm * n * 4
        bound = max(2 * mm * n * k / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
        total["ms"] += per_fwd * ms
        total["bound_ms"] += per_fwd * bound
        print(json.dumps({"shape": name, "M": mm, "K": k, "N": n, "route": route, "ms": ms,
                          "min_ms": min(times), "bound_ms": bound, "of_bound": bound / ms}),
              flush=True)
    print(json.dumps({"per_forward_ms": total["ms"], "bound_ms": total["bound_ms"],
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
