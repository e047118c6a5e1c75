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

On a ``(data, model)`` mesh of ranks (``mesh``; JAX's jitted steps under
GSPMD on sharded variables) every rank computes what one device computes on
the global batch:

* each rank reads its ``data`` rows of every batch, the first batch of
  ``init_adaround`` included (its calibrate pass reduces the observers over
  ``data``), and a blockwise or sequential run caches its own rows;
* a reconstruction MSE is a mean over the global rows: each rank divides its
  sum of squared errors by the element count summed over ``data``, and the
  recon gradients and values are summed over ``data`` (one all-reduce a
  step), the regularization's are not (its V is the same on every rank of
  the group);
* a layer on a slice of its out channels holds its slice of V; its quant
  forward gathers the output whole, so the MSE is the whole output's and
  V's gradient the slice of one device's; the regularization of the slice
  divides by the whole V's element count, and only the reported loss sums
  it over ``model``;
* the sequential dataflow's forward stops at the same layer on every rank,
  before that layer's collectives (a pre-hook), so no rank waits in a
  gather the others never reach.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..nn.layers import QuantConv, QuantDense, capture_taps
from ..nn.variables import trainable
from ..optim import Optimizer, build_optimizer
from ..parallel.mesh import axis_group
from ..quant.adaround import beta_schedule, regularization
from .base import masked_topk_correct, pad_batch
from .ptq import PTQ


def mse(a: torch.Tensor, b: torch.Tensor, count: Optional[float] = None) -> torch.Tensor:
    """The mean squared error, over ``count`` elements (default: ``a``'s)."""
    d = (a - b) ** 2
    return d.sum() / d.new_full((), float(d.numel() if count is None else count))


def global_counts(tensors, data) -> List[float]:
    """The element count of each of ``tensors`` summed over the ``data``
    group (one all-reduce, exact in float64): the divisors of a mean over
    the global rows. Without a group, their own counts."""
    counts = [float(t.numel()) for t in tensors]
    if data is None:
        return counts
    from ..parallel.tensor_parallel import all_reduce

    return all_reduce(torch.tensor(counts, dtype=torch.float64), data).tolist()


def v_layers(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """``{"adaround/<path>/w_quantizer/V": layer}`` over the dense and conv
    layers that own a V."""
    return {f"adaround/{name.replace('.', '/')}/w_quantizer/V": mod
            for name, mod in model.named_modules()
            if isinstance(mod, (QuantConv, QuantDense))
            and mod.w_quantizer.has_var("adaround", "V")}


def regularizations(leaves: Dict[str, torch.Tensor], layers: Dict[str, torch.nn.Module],
                    beta: float) -> tuple:
    """``(whole, split)``: the summed regularization of the Vs each held whole
    and of those held as a slice of a split layer's out channels (each
    divided by its whole V's element count)."""
    whole = split = 0
    for key, v in leaves.items():
        layer = layers[key]
        reg = regularization(v, beta, numel=math.prod(layer.kernel_shape))
        if layer.tp_shard is None:
            whole = whole + reg
        else:
            split = split + reg
    return whole, split


def step_grads(recon: torch.Tensor, reg: torch.Tensor, params: List[torch.Tensor], data):
    """``(recon value, gradients)`` of ``recon + reg`` for ``params``. On a
    ``data`` group ``recon`` is this rank's share of the global MSE: its
    gradients and value are summed over the group (one all-reduce), the
    regularization's, the same on every rank, are added after."""
    if data is None:
        grads = torch.autograd.grad(recon + reg, params, allow_unused=True)
        return recon.detach(), list(grads)
    from ..parallel.tensor_parallel import all_reduce

    g_rec = torch.autograd.grad(recon, params, allow_unused=True)
    g_reg = torch.autograd.grad(reg, params, allow_unused=True)
    have = [g for g in g_rec if g is not None]
    summed = all_reduce(torch.cat([g.reshape(-1) for g in have] + [recon.detach().reshape(1)]),
                        data)
    parts = iter(summed.split([g.numel() for g in have] + [1]))
    grads = []
    for a, b in zip(g_rec, g_reg):
        a = None if a is None else next(parts).view_as(a)
        grads.append(b if a is None else a if b is None else a + b)
    return next(parts).reshape(()), grads


def reported_loss(recon: torch.Tensor, whole, split, model_group) -> torch.Tensor:
    """The loss as one device reports it: ``recon`` plus the
    regularization, the split layers' shares summed over ``model``."""
    if model_group is not None and torch.is_tensor(split):
        from ..parallel.tensor_parallel import all_reduce

        split = all_reduce(split.detach().reshape(1), model_group).reshape(())
    return (recon + whole + split).detach()


def calibrate_taps(model: torch.nn.Module, img: torch.Tensor) -> dict:
    """A calibrate pass (the observers step): every tap layer's FP32
    outputs."""
    with torch.no_grad(), capture_taps(model) as fp:
        model(img, mode="calibrate")
    return fp.taps


def reconstruction_loss(model: torch.nn.Module, img: torch.Tensor, fp_taps: dict, beta: float,
                        mesh=None):
    """A quant pass's loss, logits and ``V`` gradients: the MSE of every tap
    layer's output against ``fp_taps``, summed in the order of JAX's (sorted)
    taps tree, plus every V's regularization at ``beta``.

    On a ``mesh`` ``img`` and ``fp_taps`` are this rank's rows: each tap's
    element count is summed over ``data`` (one all-reduce), then the recon
    gradients and value (one more), and on a model-sharded mesh the split
    layers' regularization value over ``model`` (module docstring); every
    rank returns the global loss and its own leaves' gradients."""
    leaves = trainable(model, ("adaround",))
    for v in leaves.values():
        v.requires_grad_(True)
    with capture_taps(model) as qt:
        logits = model(img, mode="quant")
    pairs = [(q, o) for path in sorted(qt.taps, key=lambda p: tuple(p.split("/")))
             for q, o in zip(qt.taps[path]["out"], fp_taps[path]["out"])]
    data = axis_group(mesh, "data")
    recon = 0
    for (q, o), count in zip(pairs, global_counts([q for q, _ in pairs], data)):
        recon = recon + mse(q, o, count)
    whole, split = regularizations(leaves, v_layers(model), beta)
    recon, grads = step_grads(recon, whole + split, list(leaves.values()), data)
    loss = reported_loss(recon, whole, split, axis_group(mesh, "model"))
    return loss, logits.detach(), dict(zip(leaves, grads))


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
        super().__init__(cfg, *loaders, device=device, mesh=mesh)
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
                                                  self._beta(it, total_iters), self.mesh)
        self.optimizer.step(trainable(self.model, ("adaround",)), grads)
        c, t = masked_topk_correct(logits, label)
        return float(loss), float(100.0 * c / t.clamp(min=1)), len(label)

    # -- blockwise and sequential reconstruction ------------------------------
    def ada_layers(self) -> Dict[str, torch.nn.Module]:
        """``{flax path: layer}`` of the dense and conv layers that own a V."""
        return {key[len("adaround/"):-len("/w_quantizer/V")]: mod
                for key, mod in v_layers(self.model).items()}

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
        returns the last step's loss. On a mesh the pairs are this rank's
        rows, each step's recon gradient is summed over ``data`` (one
        all-reduce), and the returned loss is the global one, the same on
        every rank (module docstring)."""
        key = f"adaround/{path}/w_quantizer/V"
        v = layer.w_quantizer.get_var("adaround", "V")
        opt = Optimizer(build_optimizer(self.cfg, steps_per_epoch=len(pairs)), {key: v})
        data = axis_group(self.mesh, "data")
        counts = global_counts([y for _, y in pairs], data)
        numel = math.prod(layer.kernel_shape)
        recon = reg = torch.zeros(())
        for it in range(steps_total):
            x_in, y_fp = (t.to(self.device, non_blocking=True) for t in pairs[it % len(pairs)])
            v = layer.w_quantizer.get_var("adaround", "V").requires_grad_(True)
            y = layer(x_in, mode="quant")
            reg = regularization(v, self._beta(it, steps_total), numel=numel)
            recon, (grad,) = step_grads(mse(y, y_fp, counts[it % len(pairs)]), reg, [v], data)
            opt.step({key: v}, {key: grad})
        if layer.tp_shard is None:
            return float(reported_loss(recon, reg, 0, None))
        return float(reported_loss(recon, 0, reg, axis_group(self.mesh, "model")))

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
        self._init_adaround(torch.from_numpy(self._rows(first)["img"]).to(self.device))
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
