"""Runner base: calibration/eval loops, meters, checkpointing.

PyTorch counterpart of ``quantize_tpu/runners/base.py`` (the reference
``BasicRunner``, ``runner/base.py:14``): epoch loop with loss/acc meters
and ETA logging, evaluation with top-1, checkpoint save/load with
best-model tracking recorded into ``cfg.runner.best``. The model's state
lives in its modules, on the runner's device (CUDA unless the caller asks
for the CPU); :attr:`BasicRunner.variables` reads and writes it under the
flax names. Steps run eagerly, where JAX jits them.
"""
from __future__ import annotations

import os
import time
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import api, convert
from ..models import build_model
from ..nn.intercept import QuantCtx
from ..nn.variables import collections
from ..utils import MovingAverageMeter, get_logger


def pad_batch(batch: Dict[str, np.ndarray], batch_size: int) -> Dict[str, np.ndarray]:
    """Pad a trailing batch to the full batch size with zero images (labels
    padded with -1 so accuracy masks them out), as the JAX runner does: its
    calibration steps see the zeros too."""
    n = len(batch["label"])
    if n == batch_size:
        return batch
    pad_n = batch_size - n
    img = np.concatenate([batch["img"], np.zeros((pad_n, *batch["img"].shape[1:]), batch["img"].dtype)])
    label = np.concatenate([batch["label"], np.full((pad_n,), -1, batch["label"].dtype)])
    return {"img": img, "label": label}


def masked_topk_correct(logits: torch.Tensor, labels: torch.Tensor, k: int = 1):
    """(#correct, #valid) with label -1 = padding."""
    valid = labels >= 0
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :k]  # jnp.argsort is stable
    correct = (topk == labels[:, None]).any(dim=-1) & valid
    return correct.sum(), valid.sum()


def masked_cross_entropy(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the labels >= 0 (padding is -1), as
    optax's ``softmax_cross_entropy_with_integer_labels`` masked."""
    valid = label >= 0
    loss = F.cross_entropy(logits.float(), label.clamp(min=0).long(), reduction="none")
    return (loss * valid).sum() / valid.sum().clamp(min=1)


class BasicRunner:
    """Base runner: owns the model and the loaders; runs on ``device``."""

    name = "base"

    def __init__(self, cfg, train_loader=None, val_loader=None, test_loader=None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the runner runs on CUDA, and torch sees no CUDA device; "
                               "pass device='cpu' (--device cpu) to run on the CPU")
        self.cfg = cfg
        self.logger = get_logger()
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader

        self.max_epoch = int(cfg.train.max_epoch or 1) if cfg.train else 1
        self.print_freq = int(cfg.train.print_freq or 10) if cfg.train else 10

        self.ctx = QuantCtx(cfg.quant) if cfg.quant else QuantCtx.fp32()
        self.model = build_model(cfg.model, ctx=self.ctx, device=self.device)
        self._initialized = False

        if cfg.model and cfg.model.checkpoint:
            self.load_checkpoint(cfg.model.checkpoint)

    # -- variables --------------------------------------------------------
    @property
    def variables(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The model's variables ``{collection: {"path/leaf": tensor}}``;
        empty until they are initialized or loaded."""
        return collections(self.model) if self._initialized else {}

    @variables.setter
    def variables(self, variables) -> None:
        """Load nested ``{collection: {module: {...: array}}}`` variables (the
        JAX package's layout), creating entries that do not exist yet."""
        convert.from_jax_variables(self.model, variables)
        self._initialized = True

    def init_variables(self, sample_batch: Dict[str, np.ndarray], seed: int = 0) -> None:
        """Initialise the parameters from ``seed`` and run one calibrate
        pass over ``sample_batch`` (JAX's ``model.init`` in calibrate mode),
        then import ``cfg.model.torch_checkpoint`` where one is set and, for
        CLIP, compute the zero-shot weights; a no-op once the variables are
        set."""
        if self._initialized:
            return
        api.init_model(self.model, sample_batch["img"], seed=seed, device=self.device)
        self._initialized = True
        self._maybe_import_torch_checkpoint()
        self._maybe_precompute_zeroshot()

    def _maybe_import_torch_checkpoint(self) -> None:
        """``cfg.model.torch_checkpoint``: convert a user-provided torch
        ``.pth`` into the initialized variables (the reference's
        pretrained-weight loading, ``modelzoo/load.py:12``; BN folded per
        ``quantconv2d.py:115-133`` where ``quant.default.bn_folding`` is set,
        into the weight quantizers' ``static_scale`` with its
        ``into_scale``), verified first against
        ``cfg.model.torch_checkpoint_sha256`` where that is set, then every
        observer reset: init ran a calibrate pass on the random weights."""
        path = self.cfg.model.torch_checkpoint if self.cfg.model else None
        if not path:
            return
        from ..models.import_auto import import_into_model, load_torch_state_dict
        from ..nn.quantizer import reset_observers

        fold = bool(self.ctx.bn_folding_enabled)
        bnf = self.ctx.default.get("bn_folding")
        into_scale = False
        if bnf is not None and not isinstance(bnf, bool):
            into_scale = bool(dict(bnf).get("into_scale"))
        self.logger.info(f"importing torch checkpoint {path} "
                         f"(fold_bn={fold}, into_scale={into_scale})")
        expected = getattr(self.cfg.model, "torch_checkpoint_sha256", None)
        if expected:
            from ..models.manifest import verify_checkpoint

            verify_checkpoint(str(path), str(expected), model_name=str(self.cfg.model.name))
        sd = load_torch_state_dict(str(path))
        import_into_model(self.model, str(self.cfg.model.name), sd, fold_bn=fold,
                          into_scale=into_scale)
        reset_observers(self.model)

    def _maybe_precompute_zeroshot(self) -> None:
        """CLIP's zero-shot weights: one pass of the text tower in fp32 over
        the class prompts (``cfg.model.classnames``, which the runner takes
        from the dataset, else ``str(i)``, times ``cfg.model.prompts``), as
        the reference's ``CLIPModel.zeroshot_classifier`` does."""
        from ..models.clip import CLIPZeroShot, build_zeroshot

        if not isinstance(self.model, CLIPZeroShot):
            return
        classnames = list(self.cfg.model.classnames or [])
        if not classnames:
            classnames = [str(i) for i in range(self.model.num_classes)]
        prompts = list(self.cfg.model.prompts or [])
        self.logger.info(f"precomputing CLIP zero-shot weights for {len(classnames)} classes")
        build_zeroshot(self.model, classnames, prompts or None)

    # -- steps (overridden by subclasses) ---------------------------------
    def train_step(self, batch, epoch: int, it: int, total_iters: int):
        raise NotImplementedError

    def eval_step(self, batch, quantized: bool = False) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(batch["img"], mode="quant" if quantized else "fp32")

    # -- loops ------------------------------------------------------------
    def _prefetch(self, loader):
        """Iterate ``loader`` with padding and background host-to-device
        prefetch (:class:`~quantize_tpu_torch.parallel.input_pipeline.PrefetchIterator`:
        pinned, copied without blocking the host), so that loading overlaps
        the device's work; an exception of the loader reaches the caller.
        The thread stops when the generator is closed or collected."""
        from ..parallel.input_pipeline import PrefetchIterator

        bs = loader.batch_size
        with PrefetchIterator((pad_batch(b, bs) for b in loader), prefetch=2,
                              device=self.device) as it:
            yield from it

    def run(self) -> None:
        """Calibration/train loop (reference ``runner/base.py:108-147``)."""
        assert self.train_loader is not None, "runner.run() needs a train loader"
        first = next(iter(self.train_loader))
        self.init_variables(pad_batch(first, self.train_loader.batch_size), seed=self.cfg.seed or 0)
        self.total_iters = self.max_epoch * len(self.train_loader)

        it = 0
        for epoch in range(self.max_epoch):
            loss_m, acc_m = MovingAverageMeter(), MovingAverageMeter()
            t0 = time.time()
            for bi, batch in enumerate(self._prefetch(self.train_loader)):
                loss, acc, n = self.train_step(batch, epoch, it, self.total_iters)
                loss_m.update(loss)
                acc_m.update(acc)
                it += 1
                if (bi + 1) % self.print_freq == 0:
                    done = epoch * len(self.train_loader) + bi + 1
                    eta = (time.time() - t0) / (bi + 1) * (self.total_iters - done)
                    self.logger.info(
                        f"epoch [{epoch + 1}/{self.max_epoch}] iter [{bi + 1}/{len(self.train_loader)}] "
                        f"loss {loss_m.avg:.4f} acc {acc_m.avg:.2f} eta {eta:.0f}s"
                    )
            self.update(epoch)

    def update(self, epoch: int) -> None:
        """End-of-epoch hook."""

    def evaluate(self, loader, quantized: bool = False) -> Dict[str, float]:
        """Eval loop (reference ``runner/base.py:149-191``)."""
        assert loader is not None
        correct = total = 0
        for batch in self._prefetch(loader):
            logits = self.eval_step(batch, quantized=quantized)
            c, t = masked_topk_correct(logits, batch["label"])
            correct += int(c)
            total += int(t)
        top1 = 100.0 * correct / max(total, 1)
        result = {"top1": top1, "n": total}
        self.logger.info(f"eval: top1 {top1:.2f}% over {total} examples (quantized={quantized})")
        return result

    # -- checkpointing ----------------------------------------------------
    def save_checkpoint(self, path: str, extra: Optional[Dict[str, Any]] = None) -> None:
        """``torch.save`` of ``{"variables": {collection: {module: {...:
        tensor}}}, "extra": extra}``: the JAX layout, as CPU tensors, so
        that loading needs no pickled code (``weights_only``)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cpu = {col: convert.unflatten({k: v.detach().cpu() for k, v in flat.items()})
               for col, flat in self.variables.items()}
        torch.save({"variables": cpu, "extra": extra or {}}, path)
        self.logger.info(f"checkpoint saved to {path}")

    def load_checkpoint(self, path: str) -> Dict[str, Any]:
        """Load a checkpoint of :meth:`save_checkpoint`, or one the JAX
        runner wrote (a pickle of flax msgpack bytes, read by
        :func:`~quantize_tpu_torch.utils.msgpack.load_jax_checkpoint`), into
        the model, creating the entries the model does not have yet
        (observer state, packed buffers); returns its ``extra``."""
        if zipfile.is_zipfile(path):  # torch.save writes a zip
            payload = torch.load(path, map_location="cpu", weights_only=True)
            variables, extra = payload["variables"], payload.get("extra", {})
        else:
            from ..utils.msgpack import load_jax_checkpoint

            variables, extra = load_jax_checkpoint(path)
        self.variables = variables
        self.logger.info(f"checkpoint loaded from {path}")
        return extra

    def save_model(self, eval_result: Optional[Dict[str, float]] = None) -> None:
        """Best-model tracking (reference ``runner/base.py:252-283``)."""
        out_dir = self.cfg.output_dir or "results"
        path = os.path.join(out_dir, "ckpt_last.pkl")
        self.save_checkpoint(path, extra={"eval": eval_result})
        if eval_result is not None:
            best = getattr(self, "_best_acc", -1.0)
            if eval_result.get("top1", -1.0) > best:
                self._best_acc = eval_result["top1"]
                best_path = os.path.join(out_dir, "ckpt_best.pkl")
                self.save_checkpoint(best_path, extra={"eval": eval_result})
                if self.cfg.runner:
                    self.cfg.runner.best = best_path
