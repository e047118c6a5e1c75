"""Everything a run feeds the program, made from ``--seed`` on the device.

Each use draws from a generator of its own (:func:`spec.sub_seed`), so the
same seed gives the same weights, calibration batches, images and
schedule, and a reference made after the window can make them again.
"""
from __future__ import annotations

import torch

from . import spec, weights

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(spec.sub_seed(seed, stream))


def image_shape(config: dict) -> tuple:
    arch = config["architecture"]
    return (int(arch["image_size"]), int(arch["image_size"]), int(arch.get("in_channels", 3)))


def state_dict(config: dict, seed: int, device) -> dict:
    return weights.state_dict(config["family"], config["architecture"],
                              spec.sub_seed(seed, "weights"), device)


def calibration(config: dict, seed: int, device) -> list:
    """The calibration batches (NHWC float32, N(0, 1) pixels)."""
    c = config["calibration"]
    gen = generator(seed, "calibration", device)
    return [torch.randn((int(c["batch"]), *image_shape(config)), generator=gen, device=device)
            for _ in range(int(c["batches"]))]


def batches(config: dict, seed: int, n: int, batch: int, device) -> list:
    """``n`` distinct timed batches of ``batch`` NHWC float32 images."""
    gen = generator(seed, "inputs", device)
    return [torch.randn((batch, *image_shape(config)), generator=gen, device=device)
            for _ in range(n)]


def pool(config: dict, seed: int, n: int, device) -> torch.Tensor:
    """``n`` distinct uint8 NHWC images, on the host."""
    gen = generator(seed, "pool", device)
    return torch.randint(0, 256, (n, *image_shape(config)), generator=gen, device=device,
                         dtype=torch.uint8).cpu()


def normalize(x_uint8: torch.Tensor) -> torch.Tensor:
    """ImageNet's normalize of ``x / 255`` (the reference's own)."""
    mean = torch.tensor(IMAGENET_MEAN, device=x_uint8.device)
    std = torch.tensor(IMAGENET_STD, device=x_uint8.device)
    return (x_uint8.float() / 255.0 - mean) / std


def schedule(traffic: dict, seconds: float, seed: int) -> tuple:
    """An open-loop arrival schedule: ``(due, sizes)``, offsets from the
    window's start in seconds and images per request.

    The set of request sizes (uniform in ``[min_images, max_images]``) and
    the set of gaps between arrivals (exponential at the rate that offers
    ``rate_img_per_s``, scaled to fill ``seconds`` exactly) are drawn from
    one fixed generator, so every seed offers the same work over the same
    time; the run's seed only orders them."""
    lo, hi = int(traffic["min_images"]), int(traffic["max_images"])
    rate_req = float(traffic["rate_img_per_s"]) / ((lo + hi) / 2.0)
    n = max(1, int(round(rate_req * seconds)))
    base = torch.Generator().manual_seed(0)
    sizes = torch.randint(lo, hi + 1, (n,), generator=base)
    gaps = torch.empty(n, dtype=torch.float64).exponential_(rate_req, generator=base)
    gaps = gaps * (seconds / float(gaps.sum()))
    order = torch.Generator().manual_seed(spec.sub_seed(seed, "schedule"))
    sizes = sizes[torch.randperm(n, generator=order)]
    gaps = gaps[torch.randperm(n, generator=order)]
    due = torch.cumsum(gaps, 0) - gaps[0]
    return [float(t) for t in due], [int(s) for s in sizes]
