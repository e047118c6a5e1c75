"""AdaRound runner: layer-wise rounding reconstruction.

PyTorch counterpart of ``quantize_tpu/runners/adaround.py`` (the reference
``AdaRound`` runner, ``runner/adaround.py:14``):

* init: a calibrate pass, then an ``init_adaround`` pass writes every
  AdaRound weight quantizer's ``V`` (h(V) = the fractional part), and the
  optimizer is built over those alone (``adaround``);
* loss = MSE(quant layer out, FP32 layer out) + the rounding regularization
  with β annealed 20 → 2 after a 20% warmup (``runner.beta: dynamic``) or
  fixed.

``cfg.runner.reconstruction`` picks the dataflow:

* ``'blockwise'`` (default): one capture pass per batch records each
  AdaRound layer's (input, FP32 output) on the host (pinned, the
  reference's ``.detach().cpu()``), then each layer's ``V`` is optimized
  alone against its cached pairs, with an optimizer state of its own.
  Device memory is one layer's step.
* ``'sequential'``: as blockwise, but layer L's inputs are recomputed
  through the quantized prefix already reconstructed (the reference's
  dataflow, ``runner/adaround.py:138-143``); targets stay the FP32 outputs.
* ``'joint'``: every step runs a calibrate pass (FP32 outputs) and a quant
  pass, the loss summed over every tapped layer's output (dense, conv,
  ReLU, pools) and every ``V``.

The layers are taken in the order of their first call in the forward, and
taps are recorded with forward hooks
(:class:`~quantize_tpu_torch.nn.layers.capture_taps`). Each step runs
eagerly, the layer module itself on its cached input.
``cfg.runner.max_cached_batches`` caps the batches a blockwise run caches.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..nn.layers import QuantConv, QuantDense, capture_taps
from ..nn.variables import trainable
from ..optim import Optimizer, build_optimizer
from ..quant.adaround import beta_schedule, regularization
from .base import masked_topk_correct, pad_batch
from .ptq import PTQ


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a - b) ** 2
    return d.sum() / d.new_full((), float(d.numel()))


def calibrate_taps(model: torch.nn.Module, img: torch.Tensor) -> dict:
    """A calibrate pass (the observers step): every tap layer's FP32
    outputs."""
    with torch.no_grad(), capture_taps(model) as fp:
        model(img, mode="calibrate")
    return fp.taps


def reconstruction_loss(model: torch.nn.Module, img: torch.Tensor, fp_taps: dict, beta: float):
    """A quant pass's loss, logits and ``V`` gradients: the MSE of every tap
    layer's output against ``fp_taps``, summed in the order of JAX's (sorted)
    taps tree, plus every V's regularization at ``beta``."""
    leaves = trainable(model, ("adaround",))
    for v in leaves.values():
        v.requires_grad_(True)
    with capture_taps(model) as qt:
        logits = model(img, mode="quant")
    recon = 0
    for path in sorted(qt.taps, key=lambda p: tuple(p.split("/"))):
        for q, o in zip(qt.taps[path]["out"], fp_taps[path]["out"]):
            recon = recon + mse(q, o)
    reg = 0
    for v in leaves.values():
        reg = reg + regularization(v, beta)
    loss = recon + reg
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), logits.detach(), dict(zip(leaves, grads))


def init_adaround(model: torch.nn.Module, img: torch.Tensor) -> None:
    """A calibrate pass, then every AdaRound weight quantizer writes its V
    (the reference's first forward runs with calibrating=True and
    quantized=True)."""
    with torch.no_grad():
        model(img, mode="calibrate")
        model(img, mode="init_adaround")


class _Stop(Exception):
    """Ends a forward once the hooked layer's input is recorded."""


class AdaRound(PTQ):
    name = "adaround"

    def __init__(self, cfg, *loaders, device="cuda", mesh=None):
        if mesh is not None and mesh.size > 1:
            raise ValueError("the AdaRound runner does not run on a mesh of ranks yet; the PTQ "
                             "runner does")
        super().__init__(cfg, *loaders, device=device)
        self.initialized = False
        self.optimizer = None
        self.layer_losses: Dict[str, float] = {}

    def _reconstruction(self) -> str:
        mode = (self.cfg.runner.reconstruction if self.cfg.runner else None) or "blockwise"
        if mode not in ("blockwise", "sequential", "joint"):
            raise ValueError(f"runner.reconstruction {mode!r}: blockwise, sequential or joint")
        return mode

    def _init_adaround(self, img: torch.Tensor) -> None:
        init_adaround(self.model, img)
        leaves = trainable(self.model, ("adaround",))
        if not leaves:
            raise ValueError(
                "AdaRound runner needs quantizers with `adaround` enabled in "
                "their weight config (quant.default.weight.adaround.apply=true)")
        steps = len(self.train_loader) if self.train_loader is not None else 1
        self.optimizer = Optimizer(build_optimizer(self.cfg, steps_per_epoch=steps), leaves)
        self.initialized = True

    def _beta(self, it: int, total_iters: int) -> float:
        beta_cfg = self.cfg.runner.beta if self.cfg.runner else None
        if beta_cfg is None or beta_cfg == "dynamic":
            return beta_schedule(it, total_iters)
        return float(beta_cfg)

    def train_step(self, batch, epoch, it, total_iters):
        img, label = batch["img"], batch["label"]
        if not self.initialized:
            self._init_adaround(img)
        loss, logits, grads = reconstruction_loss(self.model, img, calibrate_taps(self.model, img),
                                                  self._beta(it, total_iters))
        self.optimizer.step(trainable(self.model, ("adaround",)), grads)
        c, t = masked_topk_correct(logits, label)
        return float(loss), float(100.0 * c / t.clamp(min=1)), len(label)

    # -- blockwise and sequential reconstruction ------------------------------
    def ada_layers(self) -> Dict[str, torch.nn.Module]:
        """``{flax path: layer}`` of the dense and conv layers that own a V."""
        return {name.replace(".", "/"): mod for name, mod in self.model.named_modules()
                if isinstance(mod, (QuantConv, QuantDense))
                and mod.w_quantizer.has_var("adaround", "V")}

    def _store(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of a captured tensor (pinned, copied without blocking,
        from the card)."""
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def _quant_input(self, path: str, layer, img: torch.Tensor) -> torch.Tensor:
        """``layer``'s input in a quant-mode forward of ``img`` through the
        layers before it (the forward stops there)."""
        got = []

        def hook(mod, args, kwargs):
            got.append(self._store(args[0] if args else kwargs["x"]))
            raise _Stop

        handle = layer.register_forward_pre_hook(hook, with_kwargs=True)
        try:
            with torch.no_grad():
                self.model(img, mode="quant")
        except _Stop:
            pass
        finally:
            handle.remove()
        return got[0]

    def reconstruct_layer(self, path: str, layer, pairs: List, steps_total: int) -> float:
        """Optimize ``layer``'s V alone against ``pairs`` ((input, FP32
        output) host tensors, one per cached batch) for ``steps_total``
        steps, cycling over the batches, with a fresh optimizer state;
        returns the last step's loss."""
        key = f"adaround/{path}/w_quantizer/V"
        v = layer.w_quantizer.get_var("adaround", "V")
        opt = Optimizer(build_optimizer(self.cfg, steps_per_epoch=len(pairs)), {key: v})
        loss = torch.zeros(())
        for it in range(steps_total):
            x_in, y_fp = (t.to(self.device, non_blocking=True) for t in pairs[it % len(pairs)])
            v = layer.w_quantizer.get_var("adaround", "V").requires_grad_(True)
            y = layer(x_in, mode="quant")
            loss = mse(y, y_fp) + regularization(v, self._beta(it, steps_total))
            grad, = torch.autograd.grad(loss, [v])
            opt.step({key: v}, {key: grad})
        return float(loss.detach())

    def run(self) -> None:
        if self._reconstruction() == "joint":
            return super().run()
        if self.train_loader is None:
            raise ValueError("the AdaRound runner needs a train loader")
        first = pad_batch(next(iter(self.train_loader)), self.train_loader.batch_size)
        self.init_variables(first, seed=self.cfg.seed or 0)

        # PTQ pre-pass: a full calibration epoch before reconstruction
        for batch in self._prefetch(self.train_loader):
            with torch.no_grad():
                self.model(batch["img"], mode="calibrate")
        self._init_adaround(torch.from_numpy(first["img"]).to(self.device))
        layers = self.ada_layers()

        # one capture pass per batch: each AdaRound layer's (input, FP32
        # output) to the host; runner.max_cached_batches bounds the cache
        sequential = self._reconstruction() == "sequential"
        max_cached = self.cfg.runner.max_cached_batches if self.cfg.runner else None
        caches, imgs = [], []
        for batch in self._prefetch(self.train_loader):
            if max_cached and len(caches) >= int(max_cached):
                self.logger.info(f"adaround: host cache capped at {max_cached} batches "
                                 "(runner.max_cached_batches); reconstruction loops over "
                                 "the cached subset")
                break
            with torch.no_grad(), capture_taps(self.model, inputs=True, store=self._store,
                                               paths=layers) as cap:
                self.model(batch["img"], mode="fp32")
            caches.append(cap.taps)
            if sequential:
                imgs.append(batch["img"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # the layers in the order of their first call in the forward
        order = [p for p in caches[0] if p in layers]
        self.logger.info(f"adaround {self._reconstruction()}: {len(order)} layers to reconstruct")

        steps_total = self.max_epoch * max(len(caches), 1)
        for li, path in enumerate(order):
            layer = layers[path]
            if sequential:
                x_ins = [self._quant_input(path, layer, img) for img in imgs]
            else:
                x_ins = [c[path]["in"][0] for c in caches]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            pairs = [(x, c[path]["out"][0]) for x, c in zip(x_ins, caches)]
            loss = self.reconstruct_layer(path, layer, pairs, steps_total)
            self.layer_losses[path] = loss
            self.logger.info(f"adaround layer [{li + 1}/{len(order)}] {path}: loss {loss:.6f}")
        self.update(self.max_epoch - 1)
