"""The comparison that decides ``correct``.

Each compared answer is one row of logits the timed path produced; the
reference (``benchmark/reference/``) computes the same rows from the same
weights, calibration batches and inputs. The number compared is the worst
row's relative gap, ``max_r |p_r - ref_r|_2 / |ref_r|_2``, held to the
cell's limit (``benchmark/workloads/<cell>.json``: ``limits``). A row that
never came, or is not finite, fails the run.
"""
from __future__ import annotations

import json
import re
import sys

import torch
import torch.nn.functional as F

from .spec import family


def reference(config: dict, state_dict: dict, calib: list, w_bits: int = 0, a_bits: int = 0):
    """The configuration's plain reference (its family's ``Reference``),
    calibrated on ``calib``."""
    ref = family(config).Reference(state_dict, config["architecture"], config["quant"],
                                   w_bits, a_bits)
    ref.calibrate(calib)
    return ref


def row_gap(program: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row's relative L2 gap; inf where a row is not finite."""
    program, ref = program.float(), ref.float().to(program.device)
    if not bool(torch.isfinite(program).all()):
        return float("inf")
    gap = (program - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    return float(gap.max())


# kernels that compute a float32 product in TF32: cuBLAS and cuDNN name the
# type (``..._tf32f32_...``), CUTLASS its TF32 tensor-op tiles (``s1688``,
# ``s16816``)
TF32_KERNEL = re.compile(r"tf32|s1688|s16816", re.IGNORECASE)


def float32_errors(device) -> dict:
    """The relative error against float64 of a float32 matrix product and of
    a float32 conv on ``device``, as the process's precision switches stand
    when it is called: some 1e-7 in IEEE float32, some 1e-4 in TF32 (a
    10-bit mantissa). It reads what the switches do, whichever of PyTorch's
    interfaces set them."""
    gen = torch.Generator(device=device).manual_seed(0)
    a, b = (torch.randn(512, 512, generator=gen, device=device) for _ in range(2))
    x = torch.randn(8, 64, 32, 32, generator=gen, device=device)
    w = torch.randn(64, 64, 3, 3, generator=gen, device=device)

    def err(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    with torch.no_grad():
        return {"f32_matmul_err": err(a @ b, a.double() @ b.double()),
                "f32_conv_err": err(F.conv2d(x, w, padding=1),
                                    F.conv2d(x.double(), w.double(), padding=1))}


def tf32_launches(summary) -> float:
    """Launches of TF32 kernels in a traced stretch's summary."""
    return float(sum(n for name, (_, n) in summary["kernels"].items()
                     if TF32_KERNEL.search(name)))


def judge(numbers: dict, limits: dict) -> bool:
    """Each number at or under its limit (a number without a limit fails)."""
    return all(name in limits and value <= limits[name] for name, value in numbers.items())


def report(numbers: dict, limits: dict) -> dict:
    """Print each compared number beside its limit as the last lines on
    standard error; the same, for the result's line."""
    out = {name: {"value": value, "limit": limits.get(name)} for name, value in numbers.items()}
    for name, v in out.items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return out


def dumps(obj) -> str:
    return json.dumps(obj, allow_nan=False)
