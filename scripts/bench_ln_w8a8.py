#!/usr/bin/env python3
"""Kernels K7 (LayerNorm + int8 quantize) and K1 (W8A8 matmul) alone on one
GPU, at the shapes the ViT-B/16 and ResNet-50 paths give them.

    python3 scripts/bench_ln_w8a8.py [--reps 7]

Random inputs from seed 0. K7 at ViT-B/16's rows (batch 128: 25,600 rows of
768, float32 and bfloat16; at 384 x 384, batch 32: 18,688 rows of 768,
bfloat16); K1 at ResNet-50's head (256 x 2048 x 1000) and ViT-B/16's four
W8A8 projections at batch 128 (M = 25,600), its weight's K-major copy made
beforehand as ``QuantDense`` makes it. Prints one JSON line a shape: the
route taken, the per-launch CUDA-event median (``reps`` repeats of 20
launches, the wrapper's host work included), the device time per launch
(torch.profiler over 20 launches), the bound max(operations / peak,
bytes moved once / 3.35 TB/s) and the device time's share of it, and for
K7 a ``Tensor.copy_`` of as many bytes (read and written once) as a
yardstick; then the card's name and power limit. Needs a CUDA card and
nvcc; compare two versions only within one machine, in turns. The tree it
runs from is the one it measures, so it also runs from an unpacked older
tree.
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
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def event_ms(fn, reps: int, inner: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, match: str, n: int = 20):
    """Device time per call of the kernels whose name contains ``match``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages() if match in e.key)
    return us / n / 1e3 if us > 0 else None


def routes(fn) -> list:
    counts = getattr(fn, "route_launches", {})
    return [r for r, c in counts.items() if c]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_ln_w8a8: no CUDA device", file=sys.stderr)
        return 2
    from quantize_tpu_torch.ops import layernorm as ln
    from quantize_tpu_torch.ops import qmatmul as qm
    from quantize_tpu_torch.ops import reset_launch_counts

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    a_s, a_z = torch.tensor(0.04, device=dev), torch.tensor(-100.0, device=dev)
    for label, r, d, dtype in (("vit_b_16 f32", 25600, 768, torch.float32),
                               ("vit_b_16 bf16", 25600, 768, torch.bfloat16),
                               ("vit_b_16@384 bf16", 18688, 768, torch.bfloat16)):
        x = (torch.randn((r, d), generator=gen, device=dev) * 3 + 0.5).to(dtype)
        g = torch.rand(d, generator=gen, device=dev) + 0.5
        b = torch.randn(d, generator=gen, device=dev)
        args = (x, g, b, 1e-6, a_s, a_z, 0, 255)
        reset_launch_counts()
        ln.layernorm_quant_int8_rows(*args)
        took = routes(ln.layernorm_quant_int8_rows)
        nbytes = x.numel() * x.element_size() + 8 * d + x.numel()
        bound = max(14 * x.numel() / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
        ms = event_ms(lambda: ln.layernorm_quant_int8_rows(*args), opt.reps)
        dms = device_ms(lambda: ln.layernorm_quant_int8_rows(*args), "ln_q")
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms = event_ms(lambda: dst.copy_(src), opt.reps)
        print(json.dumps({"kernel": "layernorm_quant_int8", "shape": label, "rows": r, "d": d,
                          "route": took, "event_ms": ms, "device_ms": dms, "bound_ms": bound,
                          "of_bound": None if dms is None else bound / dms,
                          "copy_ms": copy_ms}), flush=True)
    for label, m, k, n in (("resnet50 head", 256, 2048, 1000), ("qkv", 25600, 768, 2304),
                           ("fc1", 25600, 768, 3072), ("fc2", 25600, 3072, 768),
                           ("proj", 25600, 768, 768)):
        q = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        vec = torch.rand(n, generator=gen, device=dev) * 0.01
        args = (q, torch.tensor(131.5, device=dev), torch.tensor(0.0123, device=dev), w,
                w.sum(0, dtype=torch.int32), vec, torch.zeros(n, device=dev), vec, True)
        try:  # a tree whose K1 takes the K-major copy
            kw = {"w_km": w.t().contiguous()}
            qm.w8a8_gemm(*args, **kw)
        except TypeError:
            kw = {}
        reset_launch_counts()
        qm.w8a8_gemm(*args, **kw)
        took = routes(qm.w8a8_gemm)
        nbytes = m * k + k * n + 12 * n + m * n * 4
        bound = max(2 * m * n * k / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
        ms = event_ms(lambda: qm.w8a8_gemm(*args, **kw), opt.reps)
        dms = device_ms(lambda: qm.w8a8_gemm(*args, **kw), "w8a8")
        print(json.dumps({"kernel": "w8a8_gemm", "shape": label, "m": m, "k": k, "n": n,
                          "route": took, "event_ms": ms, "device_ms": dms, "bound_ms": bound,
                          "of_bound": None if dms is None else bound / dms}), flush=True)
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
