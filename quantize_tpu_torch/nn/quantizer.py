"""Quantizer module: fake-quant with calibration state as variables.

PyTorch counterpart of ``quantize_tpu/nn/quantizer.py``. The mode is a call
argument; state lives in the ``qparams`` (scale, zero, optional
static_scale) and ``qobs`` (observer accumulators) collections.

Modes: ``'fp32'`` (pass-through times static_scale), ``'calibrate'``
(observer step, rewrite scale/zero, return the float value), ``'quant'``
(simulated quantization), ``'export_qparams'`` ((scale·static, zero) for the
layer's pack step) and ``'pack'`` ((q, scale·static, zero)). AdaRound and
AWQ are not ported yet and raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..quant.fakequant import fake_quant, quantize_core
from ..quant.observers import build_observer
from ..quant.qspec import QuantSpec, broadcast_to_axis
from .variables import VarModule

_STATE_KEYS = ("xmin", "xmax", "count")


class Quantizer(VarModule):
    """One fake-quantizer (for a weight or an activation tensor)."""

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

    def _apply_static(self, x: torch.Tensor) -> torch.Tensor:
        ss = self._static_scale()
        if ss is None:
            return x
        return x * broadcast_to_axis(ss, x.ndim, self.spec.channel_axis)

    def calibrate(self, x: torch.Tensor) -> None:
        """Run one observer step and write scale/zero."""
        observer = build_observer(self.spec)
        if self.has_var("qobs", "state/count"):
            state = {k: self.get_var("qobs", f"state/{k}") for k in _STATE_KEYS}
        else:
            state = observer.init_state(self.n_channels, device=x.device)
        state, s, z = observer(state, x)
        for k in _STATE_KEYS:
            self.put_var("qobs", f"state/{k}", state[k])
        self.put_var("qparams", "scale", s)
        self.put_var("qparams", "zero", z)

    def forward(self, x: torch.Tensor, mode: str = "quant"):
        spec = self.spec
        if not spec.enabled:
            return self._apply_static(x)
        if mode == "calibrate":
            self.calibrate(x)
            return self._apply_static(x)
        if mode == "fp32":
            return self._apply_static(x)

        s = self.get_var("qparams", "scale")
        z = self.get_var("qparams", "zero")
        ss = self._static_scale()
        if mode == "export_qparams":
            return (s if ss is None else s * ss), z
        if mode == "pack":
            q = quantize_core(x, s, z, spec.qmin, spec.qmax, spec.channel_axis)
            return q.detach(), (s if ss is None else s * ss), z
        if mode in ("init_adaround", "awq_vector"):
            raise NotImplementedError(
                f"quantizer mode {mode!r} (AdaRound/AWQ) is not ported to "
                "quantize_tpu_torch yet; see ROADMAP.md")
        if mode != "quant":
            raise ValueError(f"unknown quantizer mode {mode!r}")
        return fake_quant(x, s, z, spec.qmin, spec.qmax,
                          channel_axis=spec.channel_axis, static_scale=ss)
