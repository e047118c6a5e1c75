#!/usr/bin/env python3
"""Kernel K2 (fused 1x1 conv + residual + ReLU) alone on one GPU, at the
shapes ResNet-50 gives it.

    python3 scripts/bench_conv1x1.py [--batch 256] [--reps 7]

Random int8 activations and weights from seed 0 at the four bottleneck-tail
shapes of a ResNet-50 forward at 224 x 224 (M = batch * H * W rows, K the
bottleneck width, N = 4K; 3, 4, 6 and 3 launches a forward), each with the
weight's K-major copy made beforehand as the model makes it, at f32 and at
bf16 carry (residual and output in the carry dtype). Prints one JSON line
a shape and carry: the route taken, the per-launch CUDA-event median
(``reps`` repeats of 10 launches), the bound max(2 M N K / 1,979 TOP/s,
bytes moved once / 3.35 TB/s) and its share, and beside them the time of
``Tensor.copy_`` from the residual into a tensor of the output's shape and
dtype (the same stream of bytes read and written, without A and W: the rate
a plain copy reaches on this card), then a line a carry with the sums over
one forward and the card's name and power limit. Each call is checked bit
for bit against the plain version first.

It runs the K2 of whatever ``quantize_tpu_torch`` sits beside it, also one
that predates the K-major copy and the routes (then it passes no copy and
prints the route as "mma_sync"), so a copy of this script placed in an
unpacked older tree times that tree's kernel. Needs a CUDA card and nvcc;
compare two versions only within one machine, in turns.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# (stage, H = W, K, N, launches a forward) of ResNet-50's bottleneck tails
SHAPES = (("layer1", 56, 64, 256, 3), ("layer2", 28, 128, 512, 4),
          ("layer3", 14, 256, 1024, 6), ("layer4", 7, 512, 2048, 3))


def per_launch_ms(fn, reps: int) -> list:
    """CUDA-event time a call, over ``reps`` repeats of 10 calls, after 3."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return times


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=7)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_conv1x1: no CUDA device", file=sys.stderr)
        return 2
    from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual_gemm, conv1x1_residual_plain

    takes_copy = "w_km" in inspect.signature(conv1x1_residual_gemm).parameters
    routes = getattr(conv1x1_residual_gemm, "route_launches", None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for carry in (torch.float32, torch.bfloat16):
        total = {"ms": 0.0, "bound_ms": 0.0, "copy_ms": 0.0}
        for name, hw, k, n, per_fwd in SHAPES:
            m = opt.batch * hw * hw
            q = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            w = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
            res = (torch.randn((m, n), generator=gen, device=dev) * 4).to(carry)
            args = (q, torch.tensor(131.5, device=dev), torch.tensor(0.0123, device=dev), w,
                    w.sum(0, dtype=torch.int32), torch.rand(n, generator=gen, device=dev) * 0.01,
                    torch.randn(n, generator=gen, device=dev), res, True, carry)
            if takes_copy:
                args += (w.t().contiguous(),)
            before = dict(routes) if routes is not None else None
            got = conv1x1_residual_gemm(*args)
            if not torch.equal(got, conv1x1_residual_plain(*args)):
                print(f"bench_conv1x1: {name} disagrees with the plain version", file=sys.stderr)
                return 1
            route = ("mma_sync" if routes is None else
                     [r for r, c in routes.items() if c != before[r]][0])
            del got
            times = per_launch_ms(lambda: conv1x1_residual_gemm(*args), opt.reps)
            ms = statistics.median(times)
            dst = torch.empty((m, n), dtype=carry, device=dev)
            copy_ms = statistics.median(per_launch_ms(lambda: dst.copy_(res), opt.reps))
            item = res.element_size()
            nbytes = m * k + k * n + 3 * n * 4 + 2 * m * n * item
            bound = max(2 * m * n * k / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
            total["ms"] += per_fwd * ms
            total["bound_ms"] += per_fwd * bound
            total["copy_ms"] += per_fwd * copy_ms
            print(json.dumps({"shape": name, "carry": str(carry).replace("torch.", ""), "M": m,
                              "K": k, "N": n, "route": route, "ms": ms, "min_ms": min(times),
                              "bound_ms": bound, "of_bound": bound / ms, "copy_ms": copy_ms,
                              "copy_tb_s": 2 * m * n * item / copy_ms / 1e9}), flush=True)
            del q, w, res, args, dst
        print(json.dumps({"carry": str(carry).replace("torch.", ""),
                          "per_forward_ms": total["ms"], "bound_ms": total["bound_ms"],
                          "copy_ms": total["copy_ms"], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
