"""Plain reference of a quantized torchvision Vision Transformer
(Dosovitskiy et al., arXiv:2010.11929; torchvision ``vit_b_16`` layout).

Float32 PyTorch with TF32 off, from a torchvision-layout ``state_dict``. The
quantized sites follow the reference quantization recipe of the framework:
the patch conv, the q/k/v projections, both MLP linears and the head take a
fake-quantized input (one calibrated range each) and fake-quantized weights
(min-max, per output channel); the attention's out-projection takes its input
in float and its weights on MSE-searched per-channel ranges; LayerNorms,
softmax, GELU (exact erf) and the residual adds stay float. The calibration
runs the float network over the calibration batches and observes the input
of every quantized site.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import quant as Q


class ViTReference:
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
        self.sd = {k: v.float() for k, v in state_dict.items()}
        self.layers = int(arch["num_layers"])
        self.heads = int(arch["num_heads"])
        self.patch = int(arch["patch_size"])
        momentum = float(aq["range"].get("momentum", 0.1))
        sites = ["conv_proj", "heads.head"]
        for i in range(self.layers):
            p = f"encoder.layers.encoder_layer_{i}"
            sites += [f"{p}.self_attention.in_proj", f"{p}.mlp.0", f"{p}.mlp.3"]
        self.ranges = {k: Q.ActRange(momentum) for k in sites}
        self.weights = None
        self.qparams = None

    def _site(self, key: str, x: torch.Tensor) -> torch.Tensor:
        if self.qparams is None:
            self.ranges[key].observe(x)
            return x
        s, z = self.qparams[key]
        return Q.fq_act(x, s, z, self.a_bits)

    def _w(self, key: str) -> torch.Tensor:
        return self.sd[key] if self.weights is None else self.weights[key]

    def _linear(self, site: str, key: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self._site(site, x), self._w(f"{key}.weight"), self.sd[f"{key}.bias"])

    def _attention(self, p: str, x: torch.Tensor) -> torch.Tensor:
        n, s, e = x.shape
        h = self.heads
        qkv = F.linear(self._site(f"{p}.in_proj", x), self._w(f"{p}.in_proj_weight"),
                       self.sd[f"{p}.in_proj_bias"])
        q, k, v = (t.reshape(n, s, h, e // h).transpose(1, 2) for t in qkv.split(e, dim=-1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(e // h)
        out = (scores.softmax(dim=-1) @ v).transpose(1, 2).reshape(n, s, e)
        return F.linear(out, self._w(f"{p}.out_proj.weight"), self.sd[f"{p}.out_proj.bias"])

    def _forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        sd, e = self.sd, int(self.arch["hidden_dim"])
        x = x_nhwc.float().permute(0, 3, 1, 2)
        x = F.conv2d(self._site("conv_proj", x), self._w("conv_proj.weight"),
                     sd["conv_proj.bias"], self.patch)
        n = x.shape[0]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([sd["class_token"].expand(n, 1, e), x], dim=1) + sd["encoder.pos_embedding"]
        for i in range(self.layers):
            p = f"encoder.layers.encoder_layer_{i}"
            y = F.layer_norm(x, (e,), sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"], 1e-6)
            x = x + self._attention(f"{p}.self_attention", y)
            y = F.layer_norm(x, (e,), sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"], 1e-6)
            y = F.gelu(self._linear(f"{p}.mlp.0", f"{p}.mlp.0", y))
            x = x + self._linear(f"{p}.mlp.3", f"{p}.mlp.3", y)
        x = F.layer_norm(x[:, 0], (e,), sd["encoder.ln.weight"], sd["encoder.ln.bias"], 1e-6)
        return self._linear("heads.head", "heads.head", x)

    @torch.no_grad()
    def calibrate(self, batches) -> None:
        with Q.exact():
            for b in batches:
                self._forward(b)
        w = {}
        for key, t in self.sd.items():
            if key.endswith("out_proj.weight"):
                w[key] = Q.mse_weight(t, self.w_bits, 0)
            elif key.endswith("in_proj_weight"):
                # q, k and v are three layers: three sets of channel ranges,
                # which are the rows of the stacked weight alike
                w[key] = Q.minmax_weight(t, self.w_bits, 0)
            elif key.endswith(".weight") and (t.dim() == 4 or ".mlp." in key or "heads" in key):
                w[key] = Q.minmax_weight(t, self.w_bits, 0)
        self.weights = {**self.sd, **w}
        self.qparams = {k: r.qparams(self.a_bits) for k, r in self.ranges.items()}

    @torch.no_grad()
    def forward(self, x_nhwc: torch.Tensor, chunk: int = 32) -> torch.Tensor:
        if self.qparams is None:
            raise RuntimeError("calibrate() first")
        with Q.exact():
            return torch.cat([self._forward(x_nhwc[i:i + chunk])
                              for i in range(0, len(x_nhwc), chunk)])
