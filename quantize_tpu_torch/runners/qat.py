"""QAT runner: calibration epochs, then STE fine-tuning through fake quant.

PyTorch counterpart of ``quantize_tpu/runners/qat.py`` (the reference
``QAT`` runner, ``runner/qat.py:14``): epochs below ``calibrated_epoch``
calibrate as PTQ does; at the switch an optimizer is built over the weights
*and* the quantizers' scale/zero (``params`` and every ``qparams`` leaf,
``static_scale`` and ``awq_scale`` included), and training proceeds with
the masked cross-entropy through the quant-mode graph (straight-through
gradients; BatchNorm on its running statistics). ``optimizer.
qparams_lr_scale`` gives ``qparams`` an optimizer of their own whose
updates it scales (optax's ``multi_transform``).

On a ``(data, model)`` mesh of ranks (``mesh``) each rank reads its ``data``
rows; :func:`loss_and_grads` gives every rank the global batch's loss and
its own leaves' gradients (whole, or a split layer's slice), and the
optimizer runs over those leaves: its transforms are elementwise (no global
norm), so a slice's update is the slice of one device's update, and the
ranks of a ``data`` group stay bit-equal. The calibration epochs,
evaluation and checkpoints are the PTQ runner's on the mesh.

A training step is the span ``qat.step`` (:func:`~quantize_tpu_torch.
profiling.span`, on while PyTorch's profiler is), in phases: ``qat.forward``
(the quant-mode forward and the loss), ``qat.backward`` (the gradients and
their all-reduce), ``qat.optimizer`` (the leaves gathered and the update)
and ``qat.readback`` (the accuracy and both values read to the host).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.variables import trainable
from ..optim import Chain, Optimizer, Partition, Scale, build_optimizer
from ..parallel.mesh import axis_group
from ..profiling import span
from .base import masked_cross_entropy, masked_topk_correct
from .ptq import PTQ

TRAINABLE = ("params", "qparams")


def loss_and_grads(model: torch.nn.Module, img: torch.Tensor, label: torch.Tensor, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Optional[torch.Tensor]]]:
    """The masked cross-entropy of ``model``'s quant-mode forward, its
    logits, and its gradient for every trainable leaf (``params`` and
    ``qparams``; None where none reaches a leaf).

    On a ``mesh`` (:func:`~quantize_tpu_torch.parallel.make_mesh`) with
    ``data`` of 2 or more, ``img`` and ``label`` are this rank's rows: the
    count of valid labels is summed over ``data`` first (one all-reduce), so
    that each rank's ``sum(loss * valid) / max(count, 1)`` is its share of
    the global masked mean (JAX's ``_loss``, ``quantize_tpu/runners/
    qat.py:63-71``); then the gradients and the shares are summed over
    ``data`` (one all-reduce), and every rank returns the global loss and
    gradients. The layers of a model-sharded mesh run their own collectives
    (:mod:`~quantize_tpu_torch.parallel.tensor_parallel`)."""
    with span("qat.forward"):
        leaves = trainable(model, TRAINABLE)
        for t in leaves.values():
            t.requires_grad_(True)
        logits = model(img, mode="quant")
        group = axis_group(mesh, "data")
        if group is None:
            loss = masked_cross_entropy(logits, label)
        else:
            from ..parallel.tensor_parallel import all_reduce

            valid = label >= 0
            loss_vec = F.cross_entropy(logits.float(), label.clamp(min=0).long(),
                                       reduction="none")
            count = all_reduce(valid.sum().float(), group)
            loss = (loss_vec * valid).sum() / count.clamp(min=1)
    with span("qat.backward"):
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        if group is None:
            return loss.detach(), logits.detach(), dict(zip(leaves, grads))
        have = [g for g in grads if g is not None]
        summed = all_reduce(torch.cat([g.reshape(-1) for g in have]
                                      + [loss.detach().reshape(1)]), group)
    parts = iter(summed.split([g.numel() for g in have] + [1]))
    grads = [None if g is None else next(parts).view_as(g) for g in grads]
    return next(parts).reshape(()), logits.detach(), dict(zip(leaves, grads))


class QAT(PTQ):
    name = "qat"

    def __init__(self, cfg, *loaders, device="cuda", mesh=None):
        super().__init__(cfg, *loaders, device=device, mesh=mesh)
        self.calibrated_epoch = int(cfg.train.calibrated_epoch or 1)
        self.max_epoch += self.calibrated_epoch
        self.initialized = False
        self.optimizer = None

    def build_optim(self) -> None:
        steps = len(self.train_loader) if self.train_loader is not None else 1
        tx = build_optimizer(self.cfg, steps_per_epoch=steps)
        # an update scale for scale/zero (1.0: one optimizer over all leaves,
        # as the reference, runner/qat.py:43-49)
        qs = float(getattr(self.cfg.optimizer, "qparams_lr_scale", None) or 1.0)
        if qs != 1.0:
            tx = Partition({"main": tx,
                            "qparams": Chain(build_optimizer(self.cfg, steps_per_epoch=steps),
                                             Scale(qs))},
                           lambda key: "qparams" if key.startswith("qparams/") else "main")
        self.optimizer = Optimizer(tx, trainable(self.model, TRAINABLE))

    def train_step(self, batch, epoch, it, total_iters):
        if not self.initialized:
            return super().train_step(batch, epoch, it, total_iters)
        with span("qat.step"):
            img, label = batch["img"], batch["label"]
            loss, logits, grads = loss_and_grads(self.model, img, label, self.mesh)
            with span("qat.optimizer"):
                self.optimizer.step(trainable(self.model, TRAINABLE), grads)
            with span("qat.readback"):
                c, t = masked_topk_correct(logits, label)
                return float(loss), float(100.0 * c / t.clamp(min=1)), len(label)

    def update(self, epoch):
        cfg = self.cfg
        if (epoch + 1) == self.calibrated_epoch:
            eval_result = self.evaluate(self.val_loader, quantized=True) if self.val_loader else None
            self.save_model(eval_result)
            self.build_optim()
            self.initialized = True
            return
        eval_result = None
        if (epoch + 1) == self.max_epoch:
            if self.val_loader is not None:
                eval_result = self.evaluate(self.val_loader, quantized=True)
            self.save_model(eval_result)
            return
        if cfg.train.eval_freq and (epoch + 1) % cfg.train.eval_freq == 0:
            eval_result = self.evaluate(self.val_loader, quantized=True)
        if cfg.train.save_freq and (epoch + 1) % cfg.train.save_freq == 0:
            self.save_model(eval_result)
