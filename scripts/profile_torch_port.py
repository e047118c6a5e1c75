#!/usr/bin/env python3
"""Where the time of the port's packed ResNet-50 forward goes, on one GPU.

    python3 scripts/profile_torch_port.py [--batch 256] [--carry float32|bfloat16]

Builds ResNet-50 W8A8 (the configuration of chip_smoke.py: random weights
from seed 0, calibrated on 4 batches of 32, fused residual tail on), then
traces 3 packed forwards with torch.profiler and prints device time per
forward by kernel name and by group (the port's int8 kernels, torch
elementwise kernels, other), and the device's busy share of the traced
wall time. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT_KERNELS = ("w8a8_gemm_kernel", "conv1x1_res_kernel", "qconv2d_kernel")


def _group(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port int8 kernels (K1-K3)"
    if "elementwise" in name or "vectorized" in name or "reduce" in name:
        return "torch elementwise / reduce"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--carry", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    import quantize_tpu_torch as qtt
    from chip_smoke import CFG

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(n):
        return torch.randn((n, 224, 224, 3), generator=gen, device=dev)

    model = qtt.MODELS.build("resnet50", num_classes=1000, ctx=qtt.QuantCtx(CFG))
    sample = batch(32)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    qtt.pack_model(model, sample)
    qtt.set_packed_fused_residual(True)
    qtt.set_packed_carry_dtype(args.carry)
    x = batch(args.batch)
    n_fwd = 3
    with torch.inference_mode():
        for _ in range(2):
            model(x, mode="packed")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_fwd):
                model(x, mode="packed")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us and evt.device_type.name == "CUDA":
            by_name[evt.key][0] += dev_us / 1e3 / n_fwd
            by_name[evt.key][1] += evt.count / n_fwd
    total = sum(v[0] for v in by_name.values())
    card = torch.cuda.get_device_name(0)
    print(f"{card}: ResNet-50 W8A8 packed, batch {args.batch}, carry {args.carry}, fused tail on")
    if total == 0.0:
        print("the profiler recorded no device time: not measured")
        return 1
    print(f"device time {total:.3f} ms per forward; traced wall {wall_ms / n_fwd:.3f} ms per forward "
          f"(with profiler overhead); device busy {total / (wall_ms / n_fwd):.1%}")
    groups = defaultdict(float)
    for name, (ms, _) in by_name.items():
        groups[_group(name)] += ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {g}: {ms:.3f} ms ({ms / total:.1%})")
    print("top kernels (ms per forward, launches per forward):")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {ms:8.3f} ms {cnt:6.0f}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
