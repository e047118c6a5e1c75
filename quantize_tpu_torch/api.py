"""High-level convenience API (PyTorch counterpart of ``quantize_tpu/api.py``):

    import quantize_tpu_torch as qtt

    model = qtt.MODELS.build("resnet50", num_classes=1000,
                             ctx=qtt.QuantCtx(cfg_quant))
    qtt.init_model(model, sample_batch, seed=0)        # params + 1 calibrate pass
    qtt.calibrate_model(model, calib_batches)
    logits = model(x, mode="quant")                   # simulation
    deploy = qtt.pack_model(model, sample_batch)
    logits = model(x, mode="packed")                  # int8 kernels

The model's state lives in its modules, so these calls update the model in
place and return its variables under the flax names. Every entry point
runs on ``device``, CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch

from .deploy import _to_device
from .nn.variables import collections


def init_model(model: torch.nn.Module, sample_x, seed: int = 0,
               device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Initialise the parameters from ``torch.Generator().manual_seed(seed)``
    and run one calibrate pass over ``sample_x``, as the JAX package's
    ``init_model`` does (its ``model.init`` traces in calibrate mode)."""
    device = torch.device(device)
    model.to(device)
    model.init_params(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model(_to_device(sample_x, device), mode="calibrate")
    return collections(model)


def calibrate_model(model: torch.nn.Module, batches: Iterable,
                    device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Run observer calibration over ``batches`` (arrays, tensors or dicts
    with an ``'img'`` key)."""
    device = torch.device(device)
    model.to(device)
    with torch.no_grad():
        for batch in batches:
            model(_to_device(batch, device), mode="calibrate")
    return collections(model)
