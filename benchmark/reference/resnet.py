"""Plain reference of a quantized torchvision ResNet (He et al., arXiv:1512.03385).

Float32 PyTorch with TF32 off, from a torchvision-layout ``state_dict``:
BatchNorm folded into each conv (``w * g / sqrt(v + eps)``, bias
``b - m * g / sqrt(v + eps)``); each conv's and the head's input fake-quantized
on its own calibrated range; the weights fake-quantized per output channel.
The calibration runs the float network (folded, nothing quantized) over the
calibration batches and observes the input of every conv and of the head.
Bottleneck blocks carry the stride on the 3x3 conv (torchvision v1.5).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import quant as Q


def _blocks(arch: dict):
    """``(prefix, convs, downsample)`` of every block: convs as
    ``(name, stride, padding, groups)``."""
    groups = int(arch.get("groups", 1))
    in_ch = int(arch.get("stem_width", 64))
    expansion = 4 if arch["bottleneck"] else 1
    for stage, n in enumerate(arch["stage_sizes"]):
        out_ch = 64 * 2 ** stage * expansion
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            if arch["bottleneck"]:
                convs = (("conv1", 1, 0, 1), ("conv2", stride, 1, groups), ("conv3", 1, 0, 1))
            else:
                convs = (("conv1", stride, 1, 1), ("conv2", 1, 1, 1))
            ds = b == 0 and (stride != 1 or in_ch != out_ch)
            yield f"layer{stage + 1}.{b}", convs, (stride if ds else 0)
            in_ch = out_ch


class ResNetReference:
    """``calibrate(batches)``, then ``forward(x_nhwc)`` gives the fake-quantized
    network's logits. ``w_bits``/``a_bits`` default to the configuration's."""

    def __init__(self, state_dict: dict, arch: dict, quant: dict, w_bits: int = 0,
                 a_bits: int = 0):
        wq, aq = quant["default"]["weight"], quant["default"]["activation"]
        if wq["range"]["name"] != "minmax" or not (wq["symmetric"] and wq["signed"]):
            raise ValueError(f"weight quantizer {wq} has no reference here")
        if aq["range"]["name"] != "maminmax" or aq["symmetric"] or aq["granularity"] != "layer":
            raise ValueError(f"activation quantizer {aq} has no reference here")
        self.arch = arch
        self.w_bits = w_bits or int(wq["n_bits"])
        self.a_bits = a_bits or int(aq["n_bits"])
        self.momentum = float(aq["range"].get("momentum", 0.1))
        self.float_w, self.bias = {}, {}
        sd = {k: v.float() for k, v in state_dict.items()}

        def fold(conv: str, bn: str) -> None:
            mult = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + 1e-5)
            self.float_w[conv] = sd[f"{conv}.weight"] * mult.reshape(-1, 1, 1, 1)
            self.bias[conv] = sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * mult

        fold("conv1", "bn1")
        for prefix, convs, ds in _blocks(arch):
            for name, *_ in convs:
                fold(f"{prefix}.{name}", f"{prefix}.bn{name[-1]}")
            if ds:
                fold(f"{prefix}.downsample.0", f"{prefix}.downsample.1")
        self.float_w["fc"], self.bias["fc"] = sd["fc.weight"], sd["fc.bias"]
        self.ranges = {k: Q.ActRange(self.momentum) for k in self.float_w}
        self.weights = None
        self.qparams = None

    # one activation site: the float pass observes, the quantized pass rounds
    def _site(self, key: str, x: torch.Tensor) -> torch.Tensor:
        if self.qparams is None:
            self.ranges[key].observe(x)
            return x
        s, z = self.qparams[key]
        return Q.fq_act(x, s, z, self.a_bits)

    def _conv(self, key, x, stride, padding, groups=1):
        w = self.float_w[key] if self.weights is None else self.weights[key]
        return F.conv2d(self._site(key, x), w, self.bias[key], stride, padding, 1, groups)

    def _forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.float().permute(0, 3, 1, 2)
        x = F.relu(self._conv("conv1", x, 2, 3))
        x = F.max_pool2d(x, 3, 2, 1)
        for prefix, convs, ds in _blocks(self.arch):
            out = x
            for i, (name, stride, pad, groups) in enumerate(convs):
                out = self._conv(f"{prefix}.{name}", out, stride, pad, groups)
                if i < len(convs) - 1:
                    out = F.relu(out)
            identity = self._conv(f"{prefix}.downsample.0", x, ds, 0) if ds else x
            x = F.relu(out + identity)
        x = x.mean(dim=(2, 3))
        w = self.float_w["fc"] if self.weights is None else self.weights["fc"]
        return F.linear(self._site("fc", x), w, self.bias["fc"])

    @torch.no_grad()
    def calibrate(self, batches) -> None:
        with Q.exact():
            for b in batches:
                self._forward(b)
        self.weights = {k: Q.minmax_weight(w, self.w_bits, 0) for k, w in self.float_w.items()}
        self.qparams = {k: r.qparams(self.a_bits) for k, r in self.ranges.items()}

    @torch.no_grad()
    def forward(self, x_nhwc: torch.Tensor, chunk: int = 64) -> torch.Tensor:
        if self.qparams is None:
            raise RuntimeError("calibrate() first")
        with Q.exact():
            return torch.cat([self._forward(x_nhwc[i:i + chunk])
                              for i in range(0, len(x_nhwc), chunk)])
