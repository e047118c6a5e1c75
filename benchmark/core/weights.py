"""Seeded float weights in torchvision layout, made on the device.

One ``torch.Generator`` on the device draws every normal value of the model
in one call and every uniform value in another; the tensors are views of
those draws, scaled. Kernels are He/LeCun normal, so that the activations
keep their scale through the depth:

* a conv ``(Co, Ci/G, k, k)``: ``N(0, 2 / (Ci/G k k))``; a linear
  ``(out, in)``: ``N(0, 1 / in)``; biases ``0.02 N(0, 1)``;
* a BatchNorm: gamma ``1 + 0.1 N``, beta and running mean ``0.1 N``,
  running variance ``U[0.5, 1.5)``;
* a LayerNorm: weight ``1 + 0.1 N``, bias ``0.02 N``; ViT's class token and
  position embedding ``0.02 N``.
"""
from __future__ import annotations

import math

import torch


def state_dict(family: str, arch: dict, seed: int, device) -> dict:
    """The seeded torchvision-layout ``state_dict`` of ``arch`` on ``device``,
    from the family's ``weight_specs`` (``benchmark/families/<family>.py``):
    each ``(key, shape, (kind, scale))`` with ``kind`` ``normal`` (``scale``
    N), ``normal1`` (``1 + scale`` N), ``uniform`` (``U[scale, scale + 1)``)
    or ``count`` (the whole number ``scale``, drawing nothing)."""
    from .spec import family_module

    specs = family_module(family).weight_specs(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(math.prod(s) for _, s, (kind, _) in specs if kind in ("normal", "normal1"))
    n_uniform = sum(math.prod(s) for _, s, (kind, _) in specs if kind == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    sd, at = {}, {"normal": 0, "uniform": 0}
    for key, shape, (kind, scale) in specs:
        if kind == "count":
            sd[key] = torch.full(shape, scale, dtype=torch.int64, device=device)
            continue
        pool = "uniform" if kind == "uniform" else "normal"
        n = math.prod(shape)
        raw = (uniform if pool == "uniform" else normal)[at[pool]:at[pool] + n].view(shape)
        at[pool] += n
        if kind == "normal":
            sd[key] = raw * scale
        elif kind == "normal1":
            sd[key] = 1.0 + raw * scale
        else:
            sd[key] = scale + raw
    return sd
