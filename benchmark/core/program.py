"""The system under test: the PyTorch and CUDA port, reached only here.

The port is imported when a run starts, never when this module is imported.
It takes the benchmark's seeded float weights through its own import path
(``init_model(torch_state_dict=...)``: BN folded by its importer), calibrates
on the benchmark's batches (``calibrate_model``) and packs
(``pack_model``). Its precision switches (the packed carry dtype, the fused
residual tail) are set as the configuration states, for the whole run.
"""
from __future__ import annotations

import contextlib
import sys
import time

import torch

from . import inputs, spec

# the configuration's "carry" -> the dtype the packed forward carries
CARRIES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port():
    import quantize_tpu_torch as qtt

    return qtt


def build_kernels(qtt, device) -> float:
    """Build (or find already built) the port's kernel libraries, in
    parallel; seconds taken. Nothing to build off the card."""
    if torch.device(device).type != "cuda":
        return 0.0
    from quantize_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0


def switches(qtt, config: dict) -> contextlib.ExitStack:
    """The configuration's packed precision switches, while the stack lasts."""
    stack = contextlib.ExitStack()
    stack.enter_context(qtt.packed_carry(CARRIES[config.get("carry", "float32")]))
    stack.enter_context(qtt.fused_residual(bool(config.get("fused_residual", False))))
    return stack


def build_packed(qtt, config: dict, state_dict: dict, calib: list, device):
    """The configuration's model with ``state_dict`` imported, calibrated on
    ``calib`` (a list of NHWC float batches) and packed."""
    arch = config["architecture"]
    kw = spec.family(config).build_kwargs(arch)
    marks = [time.perf_counter()]
    model = qtt.MODELS.build(config["model"], num_classes=int(arch["num_classes"]),
                             ctx=qtt.QuantCtx(config["quant"]), device=device, **kw)
    marks.append(time.perf_counter())
    qtt.init_model(model, calib[0], seed=0, torch_state_dict=state_dict,
                   model_name=config["model"], device=device)
    marks.append(time.perf_counter())
    qtt.calibrate_model(model, calib, device=device)
    marks.append(time.perf_counter())
    qtt.pack_model(model, calib[0], device=device)
    marks.append(time.perf_counter())
    steps = ("build", "init_model and import", "calibrate", "pack")
    print("set-up s: " + ", ".join(f"{name} {b - a:.3f}" for name, a, b
                                   in zip(steps, marks, marks[1:])), file=sys.stderr)
    return model


def packed_from_seed(qtt, config: dict, seed: int, device):
    """:func:`build_packed` on the weights and calibration batches of
    ``seed``, which are freed once it returns."""
    with torch.no_grad():
        state_dict = inputs.state_dict(config, seed, device)
        calib = inputs.calibration(config, seed, device)
    return build_packed(qtt, config, state_dict, calib, device)
