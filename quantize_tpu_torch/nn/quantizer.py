"""Quantizer module: fake-quant with calibration state as variables.

PyTorch counterpart of ``quantize_tpu/nn/quantizer.py``. The mode is a call
argument; state lives in the ``qparams`` (scale, zero, optional
static_scale and awq_scale) and ``qobs`` (observer accumulators, under
``state/<key>``) collections.

Modes: ``'fp32'`` (pass-through times static_scale), ``'calibrate'``
(observer step, rewrite scale/zero; AWQ also writes ``awq_scale`` from the
layer's input ``pre_act`` and its ``apply_fn``), ``'quant'`` (simulated
quantization; AWQ pre-scales the weight along its in-channel axis and, with
``q_group_size``, quantizes per group), ``'export_qparams'``
((scale·static, zero) for the layer's pack step), ``'pack'`` ((q,
scale·static, zero); AWQ packs the pre-scaled weight) and
``'awq_vector'`` (the AWQ scale, or None) and ``'init_adaround'`` (with an
AdaRound spec: write ``adaround/V`` so that h(V) is the fractional part of
``x / scale - zero``, taken before any AWQ pre-scale, as JAX does). Once
``V`` exists, ``'quant'`` and ``'pack'`` round with
:func:`~quantize_tpu_torch.quant.adaround.adaround_round`, also on both AWQ
branches.

``qparams`` and ``adaround`` are buffers: a runner that trains them
updates them in place (:func:`~quantize_tpu_torch.nn.variables.trainable`).

On a mesh of ranks a quantizer knows the ``data`` group (``data_group``,
where the mesh has more than one ``data`` rank) and, as the weight
quantizer of a layer on a slice of its out channels, the ``model`` group
(``tp_group``). ``'calibrate'`` then reduces its observer's statistics over
what its tensor is split on (:mod:`~quantize_tpu_torch.quant.observers`):
an activation over ``data`` (each rank reads its rows); a weight over
``model`` where its range spans the out channels (per tensor), never over
``data`` (every rank of a ``model`` slice holds the same weight); AWQ's
input over ``data`` and its losses over both. The state and the qparams
come out the same on every rank. AWQ's ``q_group_size`` groups run along
one out column's in-features, so a slice of the out columns holds whole
groups: its scales are the slice's, one device's order kept.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from ..quant.adaround import adaround_round, init_v
from ..quant.fakequant import dequantize_core, fake_quant, quantize_core
from ..quant.observers import build_observer, group_unview, group_view
from ..quant.qspec import QuantSpec, broadcast_to_axis
from .variables import VarModule, collections, var_modules


def awq_group(spec: QuantSpec) -> int:
    """AWQ ``q_group_size`` (0 = per-out-channel, reference ``awq.py:42``)."""
    if spec.range_name == "awq":
        g = dict(spec.range_kwargs).get("q_group_size", -1)
        if g and int(g) > 0:
            return int(g)
    return 0


class Quantizer(VarModule):
    """One fake-quantizer (for a weight or an activation tensor).
    ``n_channels``: the scale/zero length (the AWQ group count with
    ``q_group_size``)."""

    # the in-channel axis of a weight, (in, out) or (kh, kw, in, out), that
    # AWQ pre-scales
    awq_in_axis = -2

    def __init__(self, spec: QuantSpec, n_channels: int, device=None):
        super().__init__()
        self.spec = spec
        self.n_channels = int(n_channels)
        self.device = torch.device(device or "cpu")
        # the slice of the out channels of a layer that runs on one
        # (parallel/tensor_parallel.py; the layer's ``set_tp_shard`` sets it):
        # the leaves this quantizer holds whole then get their gradient summed
        # over its ``model`` group
        self.layer_shard = None
        # the mesh's ``data`` group where it has two ranks or more: an
        # activation's calibration statistics are reduced over it
        self.data_group = None
        if spec.enabled:
            self.put_var("qparams", "scale",
                         torch.ones((self.n_channels,), dtype=torch.float32, device=device))
            self.put_var("qparams", "zero",
                         torch.zeros((self.n_channels,), dtype=torch.float32, device=device))

    @property
    def tp_group(self):
        return None if self.layer_shard is None else self.layer_shard.group

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a leaf used whole on a slice of the out channels: its
        gradient summed over the ``model`` group."""
        if self.tp_group is None:
            return t
        from ..parallel.tensor_parallel import identity_sum_grad

        return identity_sum_grad(t, self.tp_group)

    def _static_scale(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.has_var("qparams", "static_scale"):
            return None
        ss = self.get_var("qparams", "static_scale")
        # one per out channel is cut to the slice; any other length is whole
        return ss if ss.numel() == x.shape[self.spec.channel_axis] else self._whole(ss)

    def set_static_scale(self, value) -> None:
        """Install a fixed multiplier on the calibrated scale (BN
        fold-into-scale, reference ``quantizer.py:146-151``): ``value`` (a
        tensor, an array or a float) stored as float32 on the quantizer's
        device, the leaf created where it is absent. On a slice of the out
        channels a value with one entry per whole out channel is stored as
        the slice's, any other length whole, as :meth:`_static_scale` reads
        it back."""
        buf = next(self.buffers(), None)
        device = buf.device if buf is not None else self.device
        t = torch.as_tensor(value, dtype=torch.float32).to(device)
        shard = self.layer_shard
        if shard is not None and t.dim() == 1 and t.shape[0] == shard.n_out:
            t = shard.cut(t)
        self.put_var("qparams", "static_scale", t)

    def _awq_scale(self) -> Optional[torch.Tensor]:
        if self.has_var("qparams", "awq_scale"):
            return self._whole(self.get_var("qparams", "awq_scale"))
        return None

    def _apply_static(self, x: torch.Tensor) -> torch.Tensor:
        ss = self._static_scale(x)
        if ss is None:
            return x
        return x * broadcast_to_axis(ss, x.ndim, self.spec.channel_axis)

    def _splits(self) -> tuple:
        """``(split, pre_split)``: the ``(group, axis)`` pairs that this
        quantizer's tensor, and the layer input an AWQ weight quantizer
        reads, are split on across ranks (module docstring)."""
        rows = ((self.data_group, 0),) if self.data_group is not None else ()
        if self.spec.flag == "activation":
            return rows, ()
        sliced = ((self.tp_group, self.spec.channel_axis),) if self.tp_group is not None else ()
        if self.spec.range_name == "awq":
            return sliced, rows
        return (() if self.spec.per_channel else sliced), ()

    def calibrate(self, x: torch.Tensor, pre_act: Optional[torch.Tensor] = None,
                  apply_fn: Optional[Callable] = None) -> None:
        """Run one observer step and write scale/zero (and awq_scale)."""
        observer = build_observer(self.spec)
        awq = self.spec.range_name == "awq"
        split, pre_split = self._splits()
        keys = [leaf for col, leaf in self._var_index if col == "qobs" and leaf.startswith("state/")]
        if keys:
            state = {k[len("state/"):]: self.get_var("qobs", k) for k in keys}
        else:
            # AWQ's state is per in-channel; a per-channel weight on a slice
            # of the out channels keeps the slice's
            n = self.n_channels
            if awq:
                n = pre_act.shape[-1]
            elif self.tp_group is not None and self.spec.per_channel:
                n = x.shape[self.spec.channel_axis]
            state = observer.init_state(n, device=x.device)
        if awq:
            state, s, z, awq_scale = observer(state, x, pre_act=pre_act, apply_fn=apply_fn,
                                              split=split, pre_split=pre_split)
            self.put_var("qparams", "awq_scale", awq_scale)
        else:
            state, s, z = observer(state, x, split=split)
        for k, v in state.items():
            self.put_var("qobs", f"state/{k}", v)
        self.put_var("qparams", "scale", s)
        self.put_var("qparams", "zero", z)

    def forward(self, x: torch.Tensor, mode: str = "quant", **calib_kw):
        spec = self.spec
        if not spec.enabled:
            return self._apply_static(x)
        if mode == "calibrate":
            self.calibrate(x, **calib_kw)
            return self._apply_static(x)
        if mode == "fp32":
            return self._apply_static(x)

        s = self.get_var("qparams", "scale")
        z = self.get_var("qparams", "zero")
        if not spec.per_channel:
            s, z = self._whole(s), self._whole(z)
        ss = self._static_scale(x)
        awq_scale = self._awq_scale()
        g = awq_group(spec)
        eff = s if ss is None else s * ss
        if mode == "init_adaround":
            if spec.adaround:
                v = x / broadcast_to_axis(s, x.ndim, spec.channel_axis) - broadcast_to_axis(
                    z, x.ndim, spec.channel_axis)
                self.put_var("adaround", "V", init_v(v.detach()))
            return self._apply_static(x)
        round_fn = None
        if spec.adaround and self.has_var("adaround", "V"):
            v_off = self.get_var("adaround", "V")
            round_fn = lambda t: adaround_round(t, v_off)  # noqa: E731
        if mode == "export_qparams":
            return eff, z
        if mode == "pack":
            # AWQ packs the pre-scaled weight Q(w·awq); the layer stores 1/awq
            if awq_scale is not None:
                xs = x * broadcast_to_axis(awq_scale, x.ndim, self.awq_in_axis)
                if g:
                    q = quantize_core(group_view(xs, g), s, z, spec.qmin, spec.qmax, 0, round_fn)
                    q = group_unview(q, xs.shape)
                else:
                    q = quantize_core(xs, s, z, spec.qmin, spec.qmax, spec.channel_axis, round_fn)
                return q.detach(), eff, z
            q = quantize_core(x, s, z, spec.qmin, spec.qmax, spec.channel_axis, round_fn)
            return q.detach(), eff, z
        if mode == "awq_vector":
            return awq_scale
        if mode != "quant":
            raise ValueError(f"unknown quantizer mode {mode!r}")
        if awq_scale is not None and g:
            # grouped AWQ simulation: scale by awq, quantize per (out, in/g) group
            aws_b = broadcast_to_axis(awq_scale, x.ndim, self.awq_in_axis)
            xs = x * aws_b
            q = quantize_core(group_view(xs, g), s, z, spec.qmin, spec.qmax, 0, round_fn)
            deq = dequantize_core(q, s, z, channel_axis=0)
            return group_unview(deq, xs.shape) / aws_b
        return fake_quant(x, s, z, spec.qmin, spec.qmax, channel_axis=spec.channel_axis,
                          static_scale=ss, awq_scale=awq_scale, awq_axis=self.awq_in_axis,
                          round_fn=round_fn)


def quantize_with_qparams(x: torch.Tensor, spec: QuantSpec, qparams: Mapping) -> tuple:
    """Deploy-path quantization from an exported qparams subtree: returns
    ``(q_int, effective_scale, zero)``, ``static_scale`` folded into the
    returned scale (JAX ``quantize_with_qparams``)."""
    s, z = qparams["scale"], qparams["zero"]
    ss = qparams.get("static_scale")
    eff_scale = s if ss is None else s * ss
    q = quantize_core(x, s, z, spec.qmin, spec.qmax, spec.channel_axis)
    return q.to(spec.storage_dtype), eff_scale, z


def reset_observers(model: torch.nn.Module):
    """Drop every observer accumulator (the ``qobs`` collection: each
    quantizer's ``state/*`` and the layers' ``bias_correct_EX``), so the
    next calibrate pass restarts every observer from its identity state.

    ``init_model`` runs one calibrate pass on the random init; after real
    weights are imported its running statistics would poison the ranges
    (running min/max keeps the max over the init's and the imported
    weights). ``qparams`` are kept: scale/zero are rewritten by the next
    calibrate step, and an importer's ``static_scale`` must survive.
    Returns the model's variables."""
    for _, mod in var_modules(model):
        for col, leaf in [key for key in mod._var_index if key[0] == "qobs"]:
            mod.drop_var(col, leaf)
    return collections(model)
