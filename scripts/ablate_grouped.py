#!/usr/bin/env python3
"""Where K3g's wgmma route spends its time: the route with parts taken out.

    python3 scripts/ablate_grouped.py [--batch 256] [--reps 7]

Builds variants of ``quantize_tpu_torch/csrc/qconv2d_grouped.cu`` with nvcc
(the package's flags) into ``quantize_tpu_torch/_build/ablate/``, each with
one part of the wgmma route's work removed by a text substitution of the
source, and times each (CUDA events, ``reps`` repeats of 10 launches) at
ResNeXt-50 32x4d's stage-1 (56 x 56, 128 channels) and stage-3 (14 x 14,
512 channels) grouped convs, batch 256, float32 output:

* ``as built``: the route as the package builds it;
* ``no image reads``: every gathered piece zero-filled (src-size 0), so the
  producers issue their copies but read nothing;
* ``no corr_a reads``: the epilogue's correction map replaced by constants;
* ``no stores``: the epilogue computes every output but writes none;
* ``no wgmma``: the consumers wait for and release every stage but issue no
  product;
* ``no memory traffic``: the three memory variants at once.

Only ``as built`` gives correct outputs; the others are timings. Prints one
JSON line a shape with the times and the card's name and power limit.
Needs a CUDA card and nvcc. The substitutions name the lines they replace
and fail if the source no longer holds them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GATHER = "        cp_async16(as + (rb + 16 * i) * 128 + swz, src, ok ? 16 : 0);"
CORR = "      const float4 c4 = *reinterpret_cast<const float4*>(cp);"
STORE = "      store4(o, v);\n    } else {"
WGMMA = "        Wgmma<NS>::mma(acc[s], da + 2 * kq, db + 2 * kq, (kk > 0 || kq > 0) ? 1 : 0);"
SUBS = {
    GATHER: "        cp_async16(as + (rb + 16 * i) * 128 + swz, x, 0); (void)src; (void)ok;",
    CORR: "      const float4 c4 = make_float4(1.0f, 2.0f, 3.0f, 4.0f); (void)cp;",
    STORE: "      if (v[0] == 12345.678f) store4(o, v);\n    } else {",
    WGMMA: ("        if (kk == 0 && kq == 0) {\n#pragma unroll\n"
            "          for (int e = 0; e < NS / 2; ++e) acc[s][e] = e;\n        }"),
}
VARIANTS = (("as built", ()), ("no image reads", (GATHER,)), ("no corr_a reads", (CORR,)),
            ("no stores", (STORE,)), ("no wgmma", (WGMMA,)),
            ("no memory traffic", (GATHER, CORR, STORE)))
# (input H = W, channels) of ResNeXt-50 32x4d's stage-1 and stage-3 grouped convs
SHAPES = ((56, 128), (14, 512))
GROUPS = 32


def build(out_dir: str) -> dict:
    """Each variant's C entry point, built in parallel."""
    from quantize_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "qconv2d_grouped.cu")).read()
    for line in SUBS:
        if src.count(line) != 1:
            raise RuntimeError(f"ablate_grouped: the source no longer holds {line.strip()!r}")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, parts) in enumerate(VARIANTS):
        text = src
        for line in parts:
            text = text.replace(line, SUBS[line])
        cu, so = os.path.join(out_dir, f"v{i}.cu"), os.path.join(out_dir, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ablate_grouped: building {name!r} failed:\n{log}")
        fn = ctypes.CDLL(so).qtt_qconv2d_grouped
        fn.argtypes = _build.KERNELS["qconv2d_grouped"][2]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def per_launch_ms(fn, reps: int) -> float:
    """Median CUDA-event time a call, over ``reps`` repeats of 10 calls."""
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
    return statistics.median(times)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=7)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_grouped: no CUDA device", file=sys.stderr)
        return 2
    from quantize_tpu_torch.ops import _build
    from quantize_tpu_torch.ops.qconv import (blockdiag_weight, conv_zero_correction_map,
                                              qconv2d_grouped_int8_plain)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    fns = build(os.path.join(ROOT, "quantize_tpu_torch", "_build", "ablate"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for hw, c in SHAPES:
        cig, n = c // GROUPS, opt.batch
        q = torch.randint(-128, 128, (n, hw, hw, c), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (3, 3, cig, c), generator=gen, device=dev, dtype=torch.int8)
        pads = ((1, 1), (1, 1))
        corr = conv_zero_correction_map(w, hw, hw, (1, 1), pads)
        ws = torch.rand(c, generator=gen, device=dev) * 0.01
        wz = torch.zeros(c, device=dev)
        bias = torch.randn(c, generator=gen, device=dev)
        z, a_s = torch.tensor(131.0, device=dev), torch.tensor(0.0123, device=dev)
        w_bd = blockdiag_weight(w, GROUPS)
        out = torch.empty((n, hw, hw, c), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(fn):
            err = fn(q.data_ptr(), w_bd.data_ptr(), corr.data_ptr(), ws.data_ptr(),
                     wz.data_ptr(), bias.data_ptr(), a_s.data_ptr(), z.data_ptr(),
                     out.data_ptr(), n, hw, hw, c, hw, hw, c, 3, 3, 1, 1, 1, 1, GROUPS, 0, 0, 1,
                     _build.dtype_code(torch.float32), 1, stream)
            _build.check(err, "ablate_grouped")

        launch(fns["as built"])
        want = qconv2d_grouped_int8_plain(q, z, a_s, w, ws, wz, bias, (1, 1), pads, corr, True,
                                          torch.float32, GROUPS)
        if not torch.equal(out, want):
            print("ablate_grouped: the route as built disagrees with the plain version",
                  file=sys.stderr)
            return 1
        ms = {name: per_launch_ms(lambda: launch(fn), opt.reps) for name, fn in fns.items()}
        print(json.dumps({"H": hw, "C": c, "Ci/G": cig, "batch": n, "ms": ms, "card": card}),
              flush=True)
        del q, w, corr, out, w_bd, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
