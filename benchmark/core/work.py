"""The yardstick's arithmetic: the work a model's math needs, from its
published shapes, and the chip's published peaks.

Operations are 2 x the multiply-accumulates; bytes count each input byte
read once and each output byte written once, at the dtypes the packed
forward holds them in (int8 activations and weights, int4 weights packed two
a byte, the carry dtype for outputs and residuals, float32 for per-channel
vectors and for attention's q, k, v and output). The work of one layer is
counted per image; a batch's is ``batch`` times the activations' share plus
the weights once. Padding a program chooses (ViT's 197 rows padded to 200,
a stem rewritten as space-to-depth) is not the model's math and is not
counted.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM, dense, without sparsity, at 700 W (NVIDIA's data sheet)
PEAKS = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

ITEMSIZE = {"int8": 1, "int4": 0.5, "bfloat16": 2, "float32": 4}


@dataclass(frozen=True)
class Layer:
    """One contraction of the forward: ``kind`` names the kernel family that
    the model's math puts it on (``conv``, ``conv_residual``, ``linear``,
    ``attention``); ``macs`` per image."""
    name: str
    kind: str
    macs: int
    act_in: int        # input elements per image
    out: int           # output elements per image
    weight: int        # weight elements (once a batch)
    channels: int      # per-output-channel vectors' length (scale, bias)
    residual: int = 0  # residual elements read per image


def model_layers(config: dict) -> list:
    """Every contraction of the configuration's forward, from its family's
    ``layers`` (``benchmark/families/<family>.py``)."""
    from .spec import family

    return family(config).layers(config["architecture"])


def ops_per_image(config: dict) -> int:
    """2 x the multiply-accumulates of every conv, linear and attention
    product of one image's forward."""
    return 2 * sum(layer.macs for layer in model_layers(config))


def bound_s(layer: Layer, batch: int, peak: str, act: str, weight: str, out: str,
            residual: str = "") -> tuple:
    """``(seconds, side)``: the least time the chip could take for ``layer``
    at ``batch``, max(operations / peak, bytes / bandwidth), and which side
    bounds it."""
    ops = 2 * layer.macs * batch
    nbytes = (batch * layer.act_in * ITEMSIZE[act] + layer.weight * ITEMSIZE[weight]
              + batch * layer.out * ITEMSIZE[out] + 2 * 4 * layer.channels
              + (batch * layer.residual * ITEMSIZE[residual] if layer.residual else 0))
    t_ops, t_bytes = ops / PEAKS[peak], nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
