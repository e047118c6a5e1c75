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
``'awq_vector'`` (the AWQ scale, or None). AdaRound is not ported yet and
raises.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

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
        if spec.adaround:
            raise NotImplementedError(
                "AdaRound is not ported to quantize_tpu_torch yet; see ROADMAP.md")
        self.spec = spec
        self.n_channels = int(n_channels)
        if spec.enabled:
            self.put_var("qparams", "scale",
                         torch.ones((self.n_channels,), dtype=torch.float32, device=device))
            self.put_var("qparams", "zero",
                         torch.zeros((self.n_channels,), dtype=torch.float32, device=device))

    def _static_scale(self) -> Optional[torch.Tensor]:
        if self.has_var("qparams", "static_scale"):
            return self.get_var("qparams", "static_scale")
        return None

    def _awq_scale(self) -> Optional[torch.Tensor]:
        if self.has_var("qparams", "awq_scale"):
            return self.get_var("qparams", "awq_scale")
        return None

    def _apply_static(self, x: torch.Tensor) -> torch.Tensor:
        ss = self._static_scale()
        if ss is None:
            return x
        return x * broadcast_to_axis(ss, x.ndim, self.spec.channel_axis)

    def calibrate(self, x: torch.Tensor, pre_act: Optional[torch.Tensor] = None,
                  apply_fn: Optional[Callable] = None) -> None:
        """Run one observer step and write scale/zero (and awq_scale)."""
        observer = build_observer(self.spec)
        awq = self.spec.range_name == "awq"
        keys = [leaf for col, leaf in self._var_index if col == "qobs" and leaf.startswith("state/")]
        if keys:
            state = {k[len("state/"):]: self.get_var("qobs", k) for k in keys}
        else:
            # AWQ's state is per in-channel
            state = observer.init_state(pre_act.shape[-1] if awq else self.n_channels,
                                        device=x.device)
        if awq:
            state, s, z, awq_scale = observer(state, x, pre_act=pre_act, apply_fn=apply_fn)
            self.put_var("qparams", "awq_scale", awq_scale)
        else:
            state, s, z = observer(state, x)
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
        ss = self._static_scale()
        awq_scale = self._awq_scale()
        g = awq_group(spec)
        eff = s if ss is None else s * ss
        if mode == "export_qparams":
            return eff, z
        if mode == "pack":
            # AWQ packs the pre-scaled weight Q(w·awq); the layer stores 1/awq
            if awq_scale is not None:
                xs = x * broadcast_to_axis(awq_scale, x.ndim, self.awq_in_axis)
                if g:
                    q = quantize_core(group_view(xs, g), s, z, spec.qmin, spec.qmax, 0)
                    q = group_unview(q, xs.shape)
                else:
                    q = quantize_core(xs, s, z, spec.qmin, spec.qmax, spec.channel_axis)
                return q.detach(), eff, z
            q = quantize_core(x, s, z, spec.qmin, spec.qmax, spec.channel_axis)
            return q.detach(), eff, z
        if mode == "awq_vector":
            return awq_scale
        if mode == "init_adaround":
            raise NotImplementedError(
                "quantizer mode 'init_adaround' (AdaRound) is not ported to "
                "quantize_tpu_torch yet; see ROADMAP.md")
        if mode != "quant":
            raise ValueError(f"unknown quantizer mode {mode!r}")
        if awq_scale is not None and g:
            # grouped AWQ simulation: scale by awq, quantize per (out, in/g) group
            aws_b = broadcast_to_axis(awq_scale, x.ndim, self.awq_in_axis)
            xs = x * aws_b
            q = quantize_core(group_view(xs, g), s, z, spec.qmin, spec.qmax, 0)
            deq = dequantize_core(q, s, z, channel_axis=0)
            return group_unview(deq, xs.shape) / aws_b
        return fake_quant(x, s, z, spec.qmin, spec.qmax, channel_axis=spec.channel_axis,
                          static_scale=ss, awq_scale=awq_scale, awq_axis=self.awq_in_axis)


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
