"""Plain reference of quantization-aware training of a torchvision ViT.

Float32 PyTorch with TF32 off. The network is :mod:`.vit`'s, with every
fake quantization straight-through (:func:`.quant.fq_train`), and the
quantizers' scales and zero points trained beside the weights: the leaves are
the weights and biases, the LayerNorms, the class token and the position
embedding, and each quantizer's scale and zero (q, k and v each have their
own, of the same values). Each leaf carries the name the framework's
variables give it, so that the two can be compared leaf by leaf; tensors keep
torchvision's layout (a leaf's norm does not depend on it). The starting
ranges are :class:`.vit.ViTReference`'s calibration; the loss is the mean
softmax cross-entropy; the update is Adam as optax writes it:
``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, the step
``-lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import quant as Q
from .vit import ViTReference


class ViTTrainReference:
    def __init__(self, state_dict: dict, arch: dict, quant: dict, calib: list,
                 lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        cal = ViTReference(state_dict, arch, quant)
        cal.calibrate(calib)
        w_bits, a_bits = cal.w_bits, cal.a_bits
        self.wq = (-(1 << (w_bits - 1)), (1 << (w_bits - 1)) - 1)
        self.aq = (0, (1 << a_bits) - 1)
        self.arch, self.heads, self.layers = arch, cal.heads, cal.layers
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        sd = cal.sd
        e = int(arch["hidden_dim"])
        leaves = {"params/class_token": sd["class_token"],
                  "params/pos_embedding": sd["encoder.pos_embedding"]}

        def act(name, site):
            s, z = cal.qparams[site]
            leaves[f"qparams/{name}/a_quantizer/scale"] = s.reshape(1)
            leaves[f"qparams/{name}/a_quantizer/zero"] = z.reshape(1)

        def dense(name, w, b, site=None, mse=False):
            leaves[f"params/{name}/kernel"], leaves[f"params/{name}/bias"] = w, b
            scale = (Q.mse_scale if mse else Q.minmax_scale)(w, w_bits, 0)
            leaves[f"qparams/{name}/w_quantizer/scale"] = scale
            leaves[f"qparams/{name}/w_quantizer/zero"] = torch.zeros_like(scale)
            if site is not None:
                act(name, site)

        def ln(name, key):
            leaves[f"params/{name}/scale"] = sd[f"{key}.weight"]
            leaves[f"params/{name}/bias"] = sd[f"{key}.bias"]

        dense("conv_proj", sd["conv_proj.weight"], sd["conv_proj.bias"], "conv_proj")
        for i in range(self.layers):
            t, p = f"encoder.layers.encoder_layer_{i}", f"encoder_layer_{i}"
            ln(f"{p}/ln_1", f"{t}.ln_1")
            ln(f"{p}/ln_2", f"{t}.ln_2")
            w, b = sd[f"{t}.self_attention.in_proj_weight"], sd[f"{t}.self_attention.in_proj_bias"]
            for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
                dense(f"{p}/self_attention/{proj}", w[j * e:(j + 1) * e], b[j * e:(j + 1) * e],
                      f"{t}.self_attention.in_proj")
            dense(f"{p}/self_attention/out_proj", sd[f"{t}.self_attention.out_proj.weight"],
                  sd[f"{t}.self_attention.out_proj.bias"], mse=True)
            dense(f"{p}/mlp/linear1", sd[f"{t}.mlp.0.weight"], sd[f"{t}.mlp.0.bias"], f"{t}.mlp.0")
            dense(f"{p}/mlp/linear2", sd[f"{t}.mlp.3.weight"], sd[f"{t}.mlp.3.bias"], f"{t}.mlp.3")
        ln("ln", "encoder.ln")
        dense("head", sd["heads.head.weight"], sd["heads.head.bias"], "heads.head")
        self.leaves = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in sorted(leaves.items())}
        self.mu = {k: torch.zeros_like(v) for k, v in self.leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.leaves.items()}
        self.count = 0

    def _x(self, name, x):
        v = self.leaves
        return Q.fq_train(x, v[f"qparams/{name}/a_quantizer/scale"],
                          v[f"qparams/{name}/a_quantizer/zero"], *self.aq)

    def _w(self, name):
        v = self.leaves
        return Q.fq_train(v[f"params/{name}/kernel"], v[f"qparams/{name}/w_quantizer/scale"],
                          v[f"qparams/{name}/w_quantizer/zero"], *self.wq, axis=0)

    def _dense(self, name, x, quantize_input=True):
        x = self._x(name, x) if quantize_input else x
        return F.linear(x, self._w(name), self.leaves[f"params/{name}/bias"])

    def _ln(self, name, x):
        v, e = self.leaves, x.shape[-1]
        return F.layer_norm(x, (e,), v[f"params/{name}/scale"], v[f"params/{name}/bias"], 1e-6)

    def logits(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        v, e, h = self.leaves, int(self.arch["hidden_dim"]), self.heads
        x = F.conv2d(self._x("conv_proj", x_nhwc.float().permute(0, 3, 1, 2)),
                     self._w("conv_proj"), v["params/conv_proj/bias"], int(self.arch["patch_size"]))
        n = x.shape[0]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([v["params/class_token"].expand(n, 1, e), x], 1) + v["params/pos_embedding"]
        for i in range(self.layers):
            p = f"encoder_layer_{i}"
            y = self._ln(f"{p}/ln_1", x)
            s = y.shape[1]
            q, k, w = (self._dense(f"{p}/self_attention/{j}", y).reshape(n, s, h, e // h)
                       .transpose(1, 2) for j in ("q_proj", "k_proj", "v_proj"))
            att = ((q @ k.transpose(-1, -2)) / math.sqrt(e // h)).softmax(dim=-1) @ w
            att = att.transpose(1, 2).reshape(n, s, e)
            x = x + self._dense(f"{p}/self_attention/out_proj", att, quantize_input=False)
            y = F.gelu(self._dense(f"{p}/mlp/linear1", self._ln(f"{p}/ln_2", x)))
            x = x + self._dense(f"{p}/mlp/linear2", y)
        return self._dense("head", self._ln("ln", x[:, 0]))

    def step(self, x_nhwc: torch.Tensor, labels: torch.Tensor, tf32: bool = False) -> tuple:
        """One training step: ``(loss, gradients)`` before the update;
        ``tf32`` runs it one precision step below float32 (the control)."""
        with Q.exact(tf32):
            loss = F.cross_entropy(self.logits(x_nhwc), labels.long())
            grads = torch.autograd.grad(loss, list(self.leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(self.leaves.items(), grads)}
        self.count += 1
        with torch.no_grad():
            for k, p in self.leaves.items():
                g, mu, nu = grads[k], self.mu[k], self.nu[k]
                mu.mul_(self.b1).add_(g * (1 - self.b1))
                nu.mul_(self.b2).add_(g * g * (1 - self.b2))
                mu_hat = mu / (1 - self.b1 ** self.count)
                nu_hat = nu / (1 - self.b2 ** self.count)
                p.sub_(self.lr * mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return float(loss.detach()), grads
