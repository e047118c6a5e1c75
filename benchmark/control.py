#!/usr/bin/env python3
"""The readings that a cell's limit is set from, on the chip, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 21 22 23 --seconds 10

For each of ``--seeds``: one run of the cell as ``run.py`` makes it (the
cell's own window of ``--seconds`` and comparison), its compared numbers the
program's readings. For each of ``--control-seeds``: the control, the plain
reference computed one precision step below the configuration's, put in the
program's place and held to the reference at the configuration's precision
as a run holds the program: for inference, every 8-bit weight and
activation grid at 4 bits, on as many rows as a run compares. For training,
the program's own lower-precision path serves: its checked steps with the
fake quant computed in bfloat16 (``set_quant_sim_dtype``); the reference's
float32 steps with TF32 on are read beside it (``tf32``), and so is a planted
fault, the reference's steps on half of each batch (the mean over the
rest). With ``--tf32-program`` (training cells): whole runs of the cell, as
``run.py`` makes them, with the program switching TF32 on, which the
configuration's float32 forbids: in its first step and left on
(``left_on``, a run with ``--trace 0``), and inside every step, switched
back after it (``in_step``, a run with ``--trace 1``); both have to come
out not correct. Prints a JSON line of each reading; the benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def below(bits: int) -> int:
    """The control's grid: int4 for int8; any other width kept."""
    return 4 if bits == 8 else bits


def control_readings(cell, seed: int, device) -> dict:
    """``{reading: compared numbers}`` of the control (and a training cell's
    planted fault) on ``seed``."""
    t = cell.traffic
    if t["kind"] == "qat_steps":
        from benchmark.drivers import qat_steps as Q

        cfg = cell.config
        ref = Q.reference_steps(cfg, t, seed, device)
        return {"control": Q.compare(bf16_steps(cell, seed, device), ref),
                "tf32": Q.compare(Q.reference_steps(cfg, t, seed, device, tf32=True), ref),
                "half_batch": Q.compare(Q.reference_steps(cfg, t, seed, device,
                                                          rows=int(t["batch"]) // 2), ref)}
    return {"control": {"logit_row_gap": control_gap(cell, seed, device)}}


def bf16_steps(cell, seed: int, device) -> dict:
    """The program's checked QAT steps with its fake quant in bfloat16."""
    import tempfile
    import types

    import torch

    from benchmark.core import program
    from benchmark.drivers import qat_steps as Q
    from quantize_tpu_torch.quant.fakequant import set_quant_sim_dtype

    cfg, t = cell.config, cell.traffic
    qtt = program.port()
    r = types.SimpleNamespace(seed=seed, device=device)
    calib, batches = Q.data(cfg, t, seed, device)
    prec = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    set_quant_sim_dtype("bfloat16")
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            runner = Q.build_runner(qtt, cfg, t, out_dir, device)
            return Q.first_steps(qtt, r, runner, cfg, t, calib, batches)
    finally:
        set_quant_sim_dtype(None)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prec


def tf32_program(workload: str, seed: int, seconds: float, in_step: bool) -> dict:
    """The result line of a run of ``workload`` whose ``QAT.train_step``
    switches TF32 on for float32 products and convs (``in_step``: only
    while the step lasts)."""
    import contextlib
    import io

    import torch

    from benchmark import run
    from quantize_tpu_torch.runners import qat

    real = qat.QAT.train_step

    def step(self, *args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            return real(self, *args, **kwargs)
        finally:
            if in_step:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    qat.QAT.train_step = step
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(int(in_step))])
    finally:
        qat.QAT.train_step = real
    line = json.loads(out.getvalue().strip().splitlines()[-1]) if rc == 0 else {}
    return {"rc": rc, "correct": line.get("correct"), "compared": line.get("compared")}


def control_gap(cell, seed: int, device) -> float:
    """The control's ``logit_row_gap`` on ``seed``'s rows."""
    import torch

    from benchmark.core import check, inputs

    cfg, t = cell.config, cell.traffic
    q = cfg["quant"]["default"]
    sd, calib = inputs.state_dict(cfg, seed, device), inputs.calibration(cfg, seed, device)
    ref = check.reference(cfg, sd, calib)
    low = check.reference(cfg, sd, calib, below(int(q["weight"]["n_bits"])),
                          below(int(q["activation"]["n_bits"])))
    gen = torch.Generator().manual_seed(seed)
    if t["kind"] == "offline":
        n = int(t["keep_max"]) * int(t["rows_per_kept"])
        xs = torch.cat(inputs.batches(cfg, seed, int(t["distinct_batches"]), int(t["batch"]),
                                      device))
        x = xs[torch.randperm(len(xs), generator=gen)[:n].to(device)]
    else:
        n = int(t["compare_requests"]) * (int(t["min_images"]) + int(t["max_images"])) // 2
        pool = inputs.pool(cfg, seed, int(t["pool"]), device)
        x = inputs.normalize(pool[torch.randperm(len(pool), generator=gen)[:n]].to(device))
    return check.row_gap(low.forward(x), ref.forward(x))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--tf32-program", type=int, nargs="*", default=[],
                    help="seeds of the runs with the program switching TF32 on")
    args = ap.parse_args()

    import contextlib
    import io

    import torch

    from benchmark import run
    from benchmark.core import spec

    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"])
        line = json.loads(out.getvalue().strip().splitlines()[-1]) if rc == 0 else {}
        print(json.dumps({"reading": "program", "seed": seed, "rc": rc,
                          "compared": line.get("compared"), "metrics": line.get("metrics")}),
              flush=True)
    for seed in args.tf32_program:
        for in_step in (False, True):
            print(json.dumps({"reading": "tf32_program_" + ("in_step" if in_step else "left_on"),
                              "seed": seed, **tf32_program(args.workload, seed, args.seconds,
                                                           in_step)}), flush=True)
    dev = torch.device("cuda", 0)
    for seed in args.control_seeds:
        for reading, numbers in control_readings(cell, seed, dev).items():
            print(json.dumps({"reading": reading, "seed": seed, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
