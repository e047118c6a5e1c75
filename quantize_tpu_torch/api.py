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

from typing import Any, Dict, Iterable, Optional

import torch

from .deploy import _to_device
from .nn.variables import collections


def init_model(model: torch.nn.Module, sample_x, seed: int = 0,
               torch_state_dict: Optional[Dict[str, Any]] = None,
               model_name: Optional[str] = None, fold_bn: bool = True,
               into_scale: bool = False, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Initialise the parameters from ``torch.Generator().manual_seed(seed)``
    and run one calibrate pass over ``sample_x``, as the JAX package's
    ``init_model`` does (its ``model.init`` traces in calibrate mode).

    With ``torch_state_dict`` (a torchvision-layout state dict; ``model_name``
    picks the importer, :mod:`quantize_tpu_torch.models.import_auto`) the
    checkpoint is then imported, BN folded into the convs with ``fold_bn``
    (its multiplier installed as the weight quantizers' ``static_scale``
    with ``into_scale``), and every observer reset
    (:func:`~quantize_tpu_torch.nn.quantizer.reset_observers`), so that
    calibration sees only the imported weights."""
    device = torch.device(device)
    model.to(device)
    model.init_params(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model(_to_device(sample_x, device), mode="calibrate")
    if torch_state_dict is not None:
        from .models.import_auto import import_into_model
        from .nn.quantizer import reset_observers

        if not model_name:
            raise ValueError("init_model(torch_state_dict=...) needs model_name to pick "
                             "the importer (see models/import_auto.py)")
        import_into_model(model, model_name, torch_state_dict, fold_bn=fold_bn,
                          into_scale=into_scale)
        reset_observers(model)
    return collections(model)


def calibrate_model(model: torch.nn.Module, batches: Iterable,
                    device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """Run observer calibration over ``batches`` (arrays, tensors or dicts
    with an ``'img'`` key). On a model loaded onto a mesh each rank passes
    its own rows of every global batch (``parallel.shard_batch``); the
    observers reduce over the ranks, so every rank ends with the qparams of
    the global batches. Returns this rank's variables (on a model-sharded
    mesh as :class:`~quantize_tpu_torch.parallel.ShardedVariables`, for
    ``parallel.gather_variables``)."""
    from .parallel.tensor_parallel import rank_variables

    device = torch.device(device)
    model.to(device)
    with torch.no_grad():
        for batch in batches:
            model(_to_device(batch, device), mode="calibrate")
    return rank_variables(model)
