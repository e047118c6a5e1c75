"""PTQ runner: one calibration epoch, then quantized evaluation.

PyTorch counterpart of ``quantize_tpu/runners/ptq.py`` (the reference
``PTQ`` runner, ``runner/ptq.py:15``): each train step runs the model in
calibrate mode (observers update, output stays FP32), the end of the epoch
evaluates with fake-quant enabled and saves the best checkpoint.
"""
from __future__ import annotations

import torch

from ..parallel.mesh import axis_group
from .base import BasicRunner, masked_cross_entropy, masked_topk_correct


class PTQ(BasicRunner):
    name = "ptq"

    def train_step(self, batch, epoch, it, total_iters):
        img, label = batch["img"], batch["label"]
        with torch.no_grad():
            logits = self.model(img, mode="calibrate").float()
        loss = masked_cross_entropy(logits, label, axis_group(self.mesh, "data"))
        c, t = masked_topk_correct(logits, label)
        return float(loss), float(100.0 * c / t.clamp(min=1)), len(label)

    def update(self, epoch):
        cfg = self.cfg
        eval_result = None
        if cfg.train.eval_freq and (epoch + 1) % cfg.train.eval_freq == 0:
            eval_result = self.evaluate(self.val_loader, quantized=True)
        if cfg.train.save_freq and (epoch + 1) % cfg.train.save_freq == 0:
            self.save_model(eval_result)
        if (epoch + 1) == self.max_epoch:
            if self.val_loader is not None:
                eval_result = self.evaluate(self.val_loader, quantized=True)
            self.save_model(eval_result)
