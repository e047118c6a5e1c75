#!/usr/bin/env python3
"""Where the time of the port's packed forward goes, on one GPU.

    python3 scripts/profile_torch_port.py [--model resnet50|vit_b_16|vit_b_32] [--batch N]
                                          [--carry float32|bfloat16]
    QTPU_ATTN_INT8=1 python3 scripts/profile_torch_port.py --model vit_b_32   # K9 for K8
    python3 scripts/profile_torch_port.py --runner     # the PTQ runner's steps, ResNet-50 at 224
    python3 scripts/profile_torch_port.py --runner "resnet18@224 cross-entropy"   # another run

Builds the model of chip_smoke.py (ResNet-50 W8A8 with the fused residual
tail, batch 256 by default; ViT-B/16 W4A8, batch 128 by default; or
ViT-B/32 weight-only W4 with MSE weight ranges and 32-bit activations,
batch 256 by default; random weights from seed 0, calibrated on 4 batches
of 32; the port reads QTPU_ATTN_INT8 at call time), then traces 3
packed forwards with torch.profiler and prints device time per forward by
kernel name and by group (the port's kernels, cuBLAS matrix products,
torch elementwise kernels, other), the device's busy share of the traced
wall time, and the device time under ranges this script marks around the
port's calls: every ``quantize_act_int8`` (the activation quantize, kernel
KQ), every ``quant_matmul_wo`` (the weight-only products, kernel K5
and the operand casts around it), every ``unpack_int4_splithalf`` (the
per-call unpack of split-half int4 weights) and every
``quant_conv2d_wo`` (the weight-only patch conv).

``--runner`` profiles the PTQ runner instead, on one of chip_smoke.py's
runner runs (``RUNNER_RUNS``, by label; by default ResNet-50 from random
weights on the CPU config at 224 x 224: MinMax weights, MAMinMax
activations, folded BN; a run from a torchvision checkpoint imports the
one chip_smoke.py writes): after its calibration epoch, 3 calibration steps
(batch 64), 3 quant-mode eval batches (128) and, once packed, 3 packed eval
batches (128, fused residual tail), each reported as above. Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PORT_KERNELS = ("w8a8_gemm_kernel", "w8a8_wgmma_kernel", "conv1x1_res_kernel",
                "conv1x1_res_wgmma_kernel", "qconv2d_wgmma_kernel",
                "w4a8_gemm_kernel", "w4a8_wgmma_kernel", "ln_kernel", "ln_q_kernel",
                "ln_q_vec_kernel",
                "mha_rows_kernel", "wo_gemm_kernel", "mha_rows_int8_kernel", "mha_rows_int8_streamed_kernel",
                "absmax_kernel", "quantize_act_kernel")
RANGES = ("quantize_act_int8", "quant_matmul_wo", "unpack_int4_splithalf", "quant_conv2d_wo")


def _group(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if "gemm" in name or "nvjet" in name or "xmma" in name or "cutlass" in name:
        return "cuBLAS matrix products"
    if "elementwise" in name or "vectorized" in name or "reduce" in name:
        return "torch elementwise / reduce"
    return "other"


def _marked(fn, label):
    """``fn`` inside a profiler range named ``label``."""
    import torch

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapper


def profile_calls(fn, title: str, n_fwd: int = 3) -> int:
    """Trace ``n_fwd`` calls of ``fn`` (after 2 warm-up calls) and print
    where their device time goes, per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_fwd):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(evt, self_only=True):
        attr = "self_device_time_total" if self_only else "device_time_total"
        us = getattr(evt, attr, None)
        if us is None:
            us = getattr(evt, attr.replace("device", "cuda"), 0.0)
        return us / 1e3 / n_fwd

    by_name = defaultdict(lambda: [0.0, 0])
    ranges = {}
    for evt in prof.key_averages():
        if evt.key in RANGES:
            # a range's device time is that of the kernels inside it, which
            # are counted under their own names below
            ranges[evt.key] = (dev_ms(evt, self_only=False), evt.count / n_fwd)
            continue
        ms = dev_ms(evt)
        if ms and evt.device_type.name == "CUDA":
            by_name[evt.key][0] += ms
            by_name[evt.key][1] += evt.count / n_fwd
    total = sum(v[0] for v in by_name.values())
    print(f"{torch.cuda.get_device_name(0)}: {title}")
    if total == 0.0:
        print("the profiler recorded no device time: not measured")
        return 1
    print(f"device time {total:.3f} ms per call; traced wall {wall_ms / n_fwd:.3f} ms per call "
          f"(with profiler overhead); device busy {total / (wall_ms / n_fwd):.1%}")
    groups = defaultdict(float)
    for name, (ms, _) in by_name.items():
        groups[_group(name)] += ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {g}: {ms:.3f} ms ({ms / total:.1%})")
    for label in RANGES:
        if label in ranges:
            ms, cnt = ranges[label]
            print(f"  range {label}: {ms:.3f} ms ({ms / total:.1%}) over {cnt:.0f} calls")
    print("top kernels (ms per call, launches per call):")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {ms:8.3f} ms {cnt:6.0f}x  {name[:110]}")
    return 0


def profile_runner(qtt, run_label: str, tmp_dir: str) -> int:
    """The PTQ runner's calibration step, quant-mode eval and packed eval."""
    import torch
    import quantize_tpu_torch.runners as runners
    from chip_smoke import RUNNER_RUNS, runner_config, torchvision_state_dict
    from quantize_tpu_torch.utils import Config

    label, model, source, imported, _ = next(r for r in RUNNER_RUNS if r[0] == run_label)
    ckpt = None
    if imported:
        ckpt = os.path.join(tmp_dir, f"{model}.pth")
        torch.save(torchvision_state_dict(model, 10, seed=5), ckpt)
    argv = runner_config(tmp_dir, label, model, source, ckpt)
    cfg = Config()
    for cfg_file in argv[1:argv.index("--opts")] if "--opts" in argv else argv[1:]:
        cfg.merge_from_yaml(cfg_file)
    if "--opts" in argv:
        cfg.merge_from_list(argv[argv.index("--opts") + 1:])
    loaders = [runners._loader(cfg, which) for which in ("train", "val", "test")]
    cfg.model.num_classes = loaders[0].dataset.num_classes
    runner = runners.build_runner(cfg, *loaders)
    runner.update = lambda epoch: None  # the calibration epoch alone: no val eval, no checkpoint
    runner.run()
    calib = next(runner._prefetch(runner.train_loader))
    test = next(runner._prefetch(runner.test_loader))
    rc = profile_calls(lambda: runner.train_step(calib, 0, 0, 1),
                       f"runner {label}: calibration step, batch 64")
    rc |= profile_calls(lambda: runner.eval_step(test, quantized=True),
                        f"runner {label}: quant-mode eval, batch 128")
    qtt.pack_model(runner.model, calib["img"])
    with torch.inference_mode(), qtt.fused_residual(True):
        rc |= profile_calls(lambda: runner.model(test["img"], mode="packed"),
                            f"runner {label}: packed eval, batch 128, fused residual")
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet50", choices=["resnet50", "vit_b_16", "vit_b_32"])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--carry", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--runner", nargs="?", const="resnet50@224", default=None,
                    help="profile the PTQ runner's steps instead, on chip_smoke.py's run of "
                         "this label (default: ResNet-50 at 224)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    import quantize_tpu_torch as qtt
    import quantize_tpu_torch.nn.layers as layers
    import quantize_tpu_torch.ops.qconv as qconv
    import quantize_tpu_torch.ops.qmatmul as qmatmul
    from chip_smoke import CFG, CFG_W4A8, CFG_WO

    for mod in (qmatmul, qconv, layers):
        for label in RANGES:
            if hasattr(mod, label):
                setattr(mod, label, _marked(getattr(mod, label), label))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.runner:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp_dir:
            return profile_runner(qtt, args.runner, tmp_dir)

    cfg = {"resnet50": CFG, "vit_b_16": CFG_W4A8, "vit_b_32": CFG_WO}[args.model]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(n):
        return torch.randn((n, 224, 224, 3), generator=gen, device=dev)

    n_batch = args.batch or (128 if args.model == "vit_b_16" else 256)
    model = qtt.MODELS.build(args.model, num_classes=1000, ctx=qtt.QuantCtx(cfg))
    sample = batch(32)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    qtt.pack_model(model, sample)
    qtt.set_packed_fused_residual(True)
    qtt.set_packed_carry_dtype(args.carry)
    x = batch(n_batch)
    with torch.inference_mode():
        return profile_calls(lambda: model(x, mode="packed"),
                             f"{args.model} packed, batch {n_batch}, carry {args.carry}, "
                             f"QTPU_ATTN_INT8={os.environ.get('QTPU_ATTN_INT8', '0')}")


if __name__ == "__main__":
    sys.exit(main())
