#!/usr/bin/env python3
"""Kernel K3g (the grouped int8 conv) alone on one GPU, at the shapes
ResNeXt-50 32x4d gives it.

    python3 scripts/bench_grouped.py [--batch 256] [--reps 7] [--carry float32 bfloat16] [--forward]

Random int8 activations and weights from seed 0 at the 16 grouped 3 x 3
convs of a ResNeXt-50 32x4d forward at 224 x 224 (32 groups; Ci/G = Co/G 4,
8, 16 and 32 in stages 1-4; the first conv of stages 2-4 at stride 2; the
model's explicit padding of 1), each with the kernel's own weight copy made
beforehand as the model makes it. Each call is checked bit for bit against
the plain version first. Prints one JSON line a shape and carry: the route
taken, its launches a forward, the per-launch CUDA-event median (``reps``
repeats of 10 launches), the bound max(2 M Co Ci/G 9 / 1,979 TOP/s, bytes
moved once / 3.35 TB/s) and its share, and the time of the bf16 cuDNN
grouped conv on the dequantized tensors (the nearest library call); then a
line a carry with the sums over one forward and the card's name and power
limit. With ``--forward`` it then builds ResNeXt-50 32x4d W8A8 (1000
classes, random weights from seed 0, ``chip_smoke.py``'s quant section:
MinMax, per-channel symmetric weights, per-tensor asymmetric activations,
BN folded), calibrates it on 4 batches of 32 at 224 x 224 and packs it, and
prints the CUDA-event median of its packed forward of ``--batch`` images
with the fused residual tail at each carry.

It runs the K3g of whatever ``quantize_tpu_torch`` sits beside it, also one
that predates the routes (then it passes that tree's word copy and prints
the route as "dp4a"), so a copy of this script placed in an unpacked older
tree times that tree's kernel. Needs a CUDA card and nvcc; compare two
versions only within one machine, in turns.
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
GROUPS = 32
# (stage, input H = W, channels, stride, launches a forward) of ResNeXt-50
# 32x4d's grouped convs
SHAPES = (("layer1", 56, 128, 1, 3), ("layer2.0", 56, 256, 2, 1), ("layer2", 28, 256, 1, 3),
          ("layer3.0", 28, 512, 2, 1), ("layer3", 14, 512, 1, 5),
          ("layer4.0", 14, 1024, 2, 1), ("layer4", 7, 1024, 1, 2))


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
    import torch.nn.functional as F

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--carry", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--forward", action="store_true")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_grouped: no CUDA device", file=sys.stderr)
        return 2
    from quantize_tpu_torch.ops import qconv

    kernel, plain = qconv.qconv2d_grouped_int8, qconv.qconv2d_grouped_int8_plain
    copy = getattr(qconv, "grouped_kernel_weight", None) or qconv.grouped_weight
    routes = getattr(kernel, "route_launches", None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for carry_name in opt.carry:
        carry = getattr(torch, carry_name)
        total = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
        for name, hw, c, s, per_fwd in SHAPES:
            cig = c // GROUPS
            q = torch.randint(-128, 128, (opt.batch, hw, hw, c), generator=gen, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (3, 3, cig, c), generator=gen, device=dev,
                              dtype=torch.int8)
            pads = ((1, 1), (1, 1))
            corr = qconv.conv_zero_correction_map(w, hw, hw, (s, s), pads)
            ws = torch.rand(c, generator=gen, device=dev) * 0.01
            wz = torch.zeros(c, device=dev)
            bias = torch.randn(c, generator=gen, device=dev)
            z, a_s = torch.tensor(131.0, device=dev), torch.tensor(0.0123, device=dev)
            args = (q, z, a_s, w, ws, wz, bias, (s, s), pads, corr, True, carry, GROUPS,
                    copy(w, GROUPS))
            before = dict(routes) if routes is not None else None
            got = kernel(*args)
            if not torch.equal(got, plain(*args)):
                print(f"bench_grouped: {name} disagrees with the plain version", file=sys.stderr)
                return 1
            route = ("dp4a" if routes is None else
                     [r for r, n in routes.items() if n != before[r]][0])
            del got
            ms = statistics.median(per_launch_ms(lambda: kernel(*args), opt.reps))
            # the nearest library call: bf16 cuDNN grouped conv, dequantized operands
            x = ((q.float() + z) * a_s).permute(0, 3, 1, 2).to(torch.bfloat16)
            x = x.contiguous(memory_format=torch.channels_last)
            wd = ((w.float() + wz) * ws).permute(3, 2, 0, 1).to(torch.bfloat16)
            wd = wd.contiguous(memory_format=torch.channels_last)
            b16 = bias.to(torch.bfloat16)
            lib_ms = statistics.median(per_launch_ms(
                lambda: F.conv2d(x, wd, b16, stride=s, padding=1, groups=GROUPS), opt.reps))
            oh = (hw + 2 - 3) // s + 1
            m = opt.batch * oh * oh
            nbytes = (q.numel() + w.numel() + 3 * c * 4 + corr.numel() * 4
                      + m * c * torch.empty((), dtype=carry).element_size())
            bound = max(2 * m * c * 9 * cig / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
            total["ms"] += per_fwd * ms
            total["bound_ms"] += per_fwd * bound
            total["library_ms"] += per_fwd * lib_ms
            print(json.dumps({"shape": name, "carry": carry_name, "H": hw, "C": c,
                              "Ci/G": cig, "stride": s, "route": route, "launches": per_fwd,
                              "ms": ms, "bound_ms": bound, "of_bound": bound / ms,
                              "library_ms": lib_ms}), flush=True)
            del q, w, corr, args, x, wd
        print(json.dumps({"carry": carry_name, "per_forward_ms": total["ms"],
                          "bound_ms": total["bound_ms"], "library_ms": total["library_ms"],
                          "card": card}), flush=True)
    if opt.forward:
        forward(opt, card, dev)
    return 0


def forward(opt, card, dev) -> None:
    """The packed ResNeXt-50 32x4d forward (module docstring, ``--forward``)."""
    import torch
    import quantize_tpu_torch as qtt

    act = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}
    weight = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
              "range": {"name": "minmax"}}
    cfg = {"default": {"weight": weight, "activation": act, "bn_folding": True}}
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(n):
        return torch.randn((n, 224, 224, 3), generator=gen, device=dev)

    model = qtt.MODELS.build("resnext50_32x4d", num_classes=1000, ctx=qtt.QuantCtx(cfg))
    sample = batch(32)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    qtt.pack_model(model, sample)
    x = batch(opt.batch)
    with torch.inference_mode(), qtt.fused_residual(True):
        for carry_name in opt.carry:
            with qtt.packed_carry(getattr(torch, carry_name)):
                ms = statistics.median(per_launch_ms(lambda: model(x, mode="packed"), opt.reps))
            print(json.dumps({"model": "resnext50_32x4d", "carry": carry_name,
                              "batch": opt.batch, "packed_forward_ms": ms, "card": card}),
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
