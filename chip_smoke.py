#!/usr/bin/env python3
"""Run the quantize_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card and nvcc

Phases (any failure exits non-zero; the last line is printed only on success):

1. Set-up: the card's name and power limit, TF32 off for float32 convs and
   matmuls, and the build of every kernel from ``quantize_tpu_torch/csrc``.
2. Slice: ResNet-50 W8A8 (symmetric per-channel weights, asymmetric
   per-tensor activations, folded BN), 1000 classes, 224x224, random weights
   from seed 0: init, MinMax calibration on 4 batches of 32, pack, then 4
   requests of batch 256 served in ``mode="packed"`` with the fused residual
   tail on. The launch counters are zeroed just before the requests and read
   just after: each kernel must have run (K3 37, K2 16, K1 1 per forward).
   The outputs must be finite, within 2e-2 of the quant simulation, within
   1e-3 of the unfused path and within 5e-2 with a bf16 carry (relative to
   max|logits|).
3. Kernels: every kernel is called on the very arguments the main path gives
   it (recorded at batch 32 for the convs and 256 for the fc, f32 and bf16
   carry) and held against its plain PyTorch version: f32 outputs within
   rtol 1e-5 / atol 1e-4, bf16 outputs within one bf16 ulp.
4. Times (CUDA-event medians, batch 256): the packed forward at f32 and bf16
   carry, the float32 cuDNN forward as the yardstick, and each kernel at
   each of its main-path shapes beside its bound, its plain version and the
   nearest library call.

Before the last line it prints one JSON object with a ``kernels`` list and
the card's name and power limit; the last line is the ``{"ok": true, ...}``
contract line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth

CFG = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}

KERNEL_INFO = {
    "w8a8_gemm": ("quantize_tpu_torch/csrc/w8a8_gemm.cu",
                  "quantize_tpu/ops/pallas/qmatmul.py:86 (_w8a8_kernel)"),
    "conv1x1_residual": ("quantize_tpu_torch/csrc/conv1x1_residual.cu",
                         "quantize_tpu/ops/pallas/qconv1x1.py:36 (_conv1x1_res_kernel)"),
    "qconv2d": ("quantize_tpu_torch/csrc/qconv2d.cu",
                "quantize_tpu/ops/qconv.py:58 (quant_conv2d, XLA int8 conv)"),
}


def log(*args):
    print(*args, flush=True)


class Failure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# -- recording the main path's kernel calls ------------------------------------

def _sig(args):
    import torch

    return tuple((tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor) else repr(a)
                 for a in args)


class _Recording:
    """Stands in for a kernel wrapper: records the call, then calls it. The
    wrapper counts its launches on its module-level name, so ``launches``
    reads and writes the wrapper's own counter."""

    def __init__(self, orig, calls):
        self.orig, self.calls = orig, calls

    def __call__(self, *args):
        entry = self.calls.setdefault(_sig(args), [args, 0])
        entry[1] += 1
        return self.orig(*args)

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, value):
        self.orig.launches = value


class Recorder:
    """Swaps the module-level kernel wrappers the port calls for recorders
    that keep the first call of each distinct signature and count calls."""

    def __init__(self):
        import quantize_tpu_torch.ops.qconv as qconv
        import quantize_tpu_torch.ops.qconv1x1 as qconv1x1
        import quantize_tpu_torch.ops.qmatmul as qmatmul

        self.sites = {"w8a8_gemm": (qmatmul, "w8a8_gemm"),
                      "conv1x1_residual": (qconv1x1, "conv1x1_residual_gemm"),
                      "qconv2d": (qconv, "qconv2d_int8")}
        self.calls = {name: {} for name in self.sites}

    def __enter__(self):
        self.saved = {}
        for name, (mod, attr) in self.sites.items():
            self.saved[name] = getattr(mod, attr)
            setattr(mod, attr, _Recording(self.saved[name], self.calls[name]))
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.sites.items():
            setattr(mod, attr, self.saved[name])


# -- timing and bounds ------------------------------------------------------------

def cuda_ms(fn, reps: int = 5, inner: int = 1, warmup: int = 2) -> float:
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls each."""
    import torch

    for _ in range(warmup):
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


def work(name: str, args) -> tuple:
    """(int8 ops, bytes moved once) of one kernel call."""
    import torch

    def nbytes(t):
        return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0

    if name == "w8a8_gemm":
        q, _, _, w, cs, ws, wz, bias, _ = args
        m, k = q.shape
        n = w.shape[1]
        return 2 * m * n * k, sum(map(nbytes, (q, w, cs, ws, wz, bias))) + m * n * 4
    if name == "conv1x1_residual":
        q, _, _, w, cs, ws, bias, res, _, out_dtype = args
        m, k = q.shape
        n = w.shape[1]
        out_b = m * n * torch.empty((), dtype=out_dtype).element_size()
        return 2 * m * n * k, sum(map(nbytes, (q, w, cs, ws, bias, res))) + out_b
    q, _, _, w, ws, wz, bias, strides, pads, corr, _, out_dtype = args
    n_img = q.shape[0]
    kh, kw, ci, co = w.shape
    oh, ow = corr.shape[1:3]
    out_b = n_img * oh * ow * co * torch.empty((), dtype=out_dtype).element_size()
    return (2 * n_img * oh * ow * co * kh * kw * ci,
            sum(map(nbytes, (q, w, ws, wz, bias, corr))) + out_b)


def bound_ms(ops: int, nbytes: int) -> tuple:
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_call(name: str, args):
    """One PyTorch call computing the same function, for the yardstick:
    torch._int_mm plus the epilogue in torch ops (K1, K2); a bf16 cuDNN conv
    on the dequantized tensors (K3, the nearest call: torch has no CUDA int8
    convolution). None where the library call does not take the shape."""
    import torch
    import torch.nn.functional as F

    if name in ("w8a8_gemm", "conv1x1_residual"):
        q, z, a_s, w = args[:4]
        if q.shape[0] <= 16 or q.shape[1] % 8 or w.shape[1] % 8:
            return None
        if name == "w8a8_gemm":
            _, _, _, _, cs, ws, _, bias, _ = args
            return lambda: (a_s * ws) * (torch._int_mm(q, w).float() + z * cs) + bias
        _, _, _, _, cs, ws, bias, res, relu, out_dtype = args
        return lambda: torch.relu((a_s * ws) * (torch._int_mm(q, w).float() + z * cs)
                                  + bias + res.float()).to(out_dtype)
    q, z, a_s, w, ws, wz, bias, strides, pads, corr, _, out_dtype = args
    (pt, pb), (pl, pr) = pads
    x = F.pad(((q.float() + z) * a_s).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wd = ((w.float() + wz) * ws).permute(3, 2, 0, 1).to(torch.bfloat16)
    wd = wd.contiguous(memory_format=torch.channels_last)
    b16 = bias.to(torch.bfloat16)
    return lambda: F.conv2d(x, wd, b16, stride=tuple(strides))


def plain_fn(name: str):
    from quantize_tpu_torch.ops.qconv import qconv2d_int8_plain
    from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual_plain
    from quantize_tpu_torch.ops.qmatmul import w8a8_gemm_plain

    return {"w8a8_gemm": w8a8_gemm_plain, "conv1x1_residual": conv1x1_residual_plain,
            "qconv2d": qconv2d_int8_plain}[name]


def kernel_fn(name: str):
    from quantize_tpu_torch.ops import KERNEL_WRAPPERS

    return KERNEL_WRAPPERS[name]


def compare(name: str, args) -> float:
    """Run the kernel and its plain version on ``args``; return max|diff|
    and fail outside the tolerance of the output dtype."""
    import torch

    got = kernel_fn(name)(*args)
    want = plain_fn(name)(*args)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype, f"{name}: shape/dtype mismatch")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if got.dtype == torch.bfloat16:
        # one bf16 ulp of the larger magnitude: 2^(exponent - 7)
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
        ok = bool(((g - w).abs() <= ulp).all())
    else:
        ok = bool(((g - w).abs() <= 1e-4 + 1e-5 * w.abs()).all())
    check(ok and bool(torch.isfinite(g).all()), f"{name}: kernel disagrees with its plain version "
                                                f"(max abs err {err})")
    return err


def describe(name: str, args) -> str:
    if name == "qconv2d":
        q, w, strides = args[0], args[3], args[7]
        return (f"x{tuple(q.shape)} w{tuple(w.shape)} s{tuple(strides)} "
                f"out={str(args[11]).replace('torch.', '')}")
    extra = f" out={str(args[9]).replace('torch.', '')}" if name == "conv1x1_residual" else ""
    return f"M={args[0].shape[0]} K={args[0].shape[1]} N={args[3].shape[1]}{extra}"


# -- the run ------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        import quantize_tpu_torch as qtt
        from quantize_tpu_torch.ops import _build, launch_counts, reset_launch_counts
    except ImportError as exc:
        print(f"chip_smoke: the quantize_tpu_torch package is not here ({exc})", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.time()
    reports = _build.build_all()
    log(f"build: {len(reports)} kernel libraries in {time.time() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line:
                log(f"  {name}: {line.split(':', 1)[-1].strip()}")
    for name in _build.KERNELS:
        _build.kernel_fn(name)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(n):
        return torch.randn((n, 224, 224, 3), generator=gen, device=dev)

    # ---- slice: init -> calibrate -> pack -> serve --------------------------------
    t0 = time.time()
    model = qtt.MODELS.build("resnet50", num_classes=1000, ctx=qtt.QuantCtx(CFG))
    sample = batch(32)
    qtt.init_model(model, sample, seed=0)
    qtt.calibrate_model(model, [batch(32) for _ in range(4)])
    qtt.pack_model(model, sample)
    torch.cuda.synchronize()
    log(f"slice set-up (init, calibrate 4x32, pack) {time.time() - t0:.1f} s")

    requests = [batch(256) for _ in range(4)]
    with torch.inference_mode():
        qtt.set_packed_fused_residual(True)
        model(requests[0], mode="packed")  # first call outside the counted run
        torch.cuda.synchronize()
        reset_launch_counts()
        outs = [model(x, mode="packed") for x in requests]
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"served {len(requests)} requests of 256 with launches {counts}")
        per_fwd = {"qconv2d": 37, "conv1x1_residual": 16, "w8a8_gemm": 1}
        for name, n in per_fwd.items():
            check(counts[name] == n * len(requests),
                  f"{name}: {counts[name]} launches, expected {n * len(requests)}")
        for out in outs:
            check(tuple(out.shape) == (256, 1000) and bool(torch.isfinite(out).all()),
                  "packed logits not finite or of the wrong shape")

        def rel(a, b):
            return float((a.float() - b.float()).abs().max() / b.float().abs().max())

        x0, packed = requests[0], outs[0]
        sim = model(x0, mode="quant")
        qtt.set_packed_fused_residual(False)
        unfused = model(x0, mode="packed")
        qtt.set_packed_fused_residual(True)
        with qtt.packed_carry(torch.bfloat16):
            packed_bf16 = model(x0, mode="packed")
        r_sim, r_fuse, r_bf16 = rel(packed, sim), rel(packed, unfused), rel(packed_bf16, packed)
        log(f"agreement (relative to max|logits|): packed vs quant-sim {r_sim:.3e} (<= 2e-2), "
            f"fused vs unfused {r_fuse:.3e} (<= 1e-3), bf16 carry vs f32 {r_bf16:.3e} (<= 5e-2)")
        check(r_sim <= 2e-2 and r_fuse <= 1e-3 and r_bf16 <= 5e-2, "slice agreement failed")
        top1 = float((packed.argmax(-1) == sim.argmax(-1)).float().mean())
        log(f"argmax agreement packed vs quant-sim on request 0: {top1:.4f}")

        # ---- kernels: record the main path's calls --------------------------------
        small = batch(32)
        records = []
        for carry in (torch.float32, torch.bfloat16):
            with qtt.packed_carry(carry), Recorder() as rec:
                model(small, mode="packed")
            records.append(rec.calls)
        with Recorder() as serve_rec:
            model(requests[1], mode="packed")

        max_err = {name: 0.0 for name in KERNEL_INFO}
        checks = [(name, args) for calls in records for name in ("qconv2d", "conv1x1_residual")
                  for args, _ in calls[name].values()]
        checks += [("w8a8_gemm", args) for args, _ in serve_rec.calls["w8a8_gemm"].values()]
        for name, args in checks:
            max_err[name] = max(max_err[name], compare(name, args))
        n_checked = len(checks)
        log(f"kernel phase: {n_checked} kernel-vs-plain comparisons passed; max abs err {max_err}")

        # ---- times ------------------------------------------------------------
        times = {}
        for label, carry in (("packed f32 carry", torch.float32),
                             ("packed bf16 carry", torch.bfloat16)):
            with qtt.packed_carry(carry):
                times[label] = cuda_ms(lambda: model(requests[2], mode="packed"))
        times["fp32 cuDNN forward (yardstick)"] = cuda_ms(lambda: model(requests[2], mode="fp32"))
        for label, ms in times.items():
            log(f"time: {label}: {ms:.3f} ms per batch of 256, {256e3 / ms:.1f} img/s [{card}]")

        entries = []
        for name, sigs in serve_rec.calls.items():
            agg = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                   "ops_ms": 0.0, "bytes_ms": 0.0}
            library_ok = True
            for args, per_fwd in sigs.values():
                ops, nbytes = work(name, args)
                b_ms, b_by = bound_ms(ops, nbytes)
                k_ms = cuda_ms(lambda: kernel_fn(name)(*args), reps=5, inner=10)
                p_ms = cuda_ms(lambda: plain_fn(name)(*args), reps=3, warmup=1)
                lib = library_call(name, args)
                l_ms = cuda_ms(lib, reps=5, inner=5) if lib is not None else None
                library_ok = library_ok and l_ms is not None
                log(f"kernel {name} {describe(name, args)}: x{per_fwd}/fwd {k_ms:.4f} ms "
                    f"(bound {b_ms:.4f} ms by {b_by}, {b_ms / k_ms:.1%} of it), plain {p_ms:.3f} ms, "
                    f"library {'n/a' if l_ms is None else f'{l_ms:.4f} ms'}")
                agg["ms"] += per_fwd * k_ms
                agg["plain_ms"] += per_fwd * p_ms
                agg["bound_ms"] += per_fwd * b_ms
                agg["ops_ms"] += per_fwd * ops / PEAK_INT8_OPS * 1e3
                agg["bytes_ms"] += per_fwd * nbytes / PEAK_BYTES * 1e3
                agg["library_ms"] += per_fwd * (l_ms or 0.0)
            src, replaces = KERNEL_INFO[name]
            entries.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": counts[name], "max_abs_err": max_err[name],
                "ms": agg["ms"], "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
                "bound_by": "operations" if agg["ops_ms"] >= agg["bytes_ms"] else "bytes",
                "library_ms": agg["library_ms"] if library_ok else None,
            })
    log("kernel times above are per launch; the JSON sums them over one forward at batch 256 "
        "(each shape's time x its launches per forward)")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
