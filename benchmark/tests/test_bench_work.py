"""The yardstick's arithmetic at known shapes."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark.core import work

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, macs, kinds", [
    # torchvision's published counts: ResNet-50 4.09 GMACs, ViT-B/16 17.56 GMACs
    ("resnet50_w8a8", 4_089_184_256, {"conv": 37, "conv_residual": 16, "linear": 1}),
    ("vit_b16_w4a8", 17_563_828_224, {"conv": 1, "linear": 37, "linear_wo": 12,
                                       "attention": 12}),
])
def test_model_work(name, macs, kinds):
    layers = work.model_layers(config(name))
    assert sum(layer.macs for layer in layers) == macs
    assert work.ops_per_image(config(name)) == 2 * macs
    assert {k: sum(layer.kind == k for layer in layers) for k in kinds} == kinds


def test_one_conv_bound_by_hand():
    # ResNet-50's layer1.0.conv2: 3x3, 64 -> 64 at 56 x 56
    layer = {x.name: x for x in work.model_layers(config("resnet50_w8a8"))}["layer1.0.conv2"]
    assert (layer.macs, layer.act_in, layer.out, layer.weight) == (
        56 * 56 * 64 * 9 * 64, 56 * 56 * 64, 56 * 56 * 64, 9 * 64 * 64)
    t, side = work.bound_s(layer, 256, "int8", "int8", "int8", "bfloat16")
    ops = 2 * 256 * 56 * 56 * 64 * 9 * 64
    nbytes = 256 * 56 * 56 * 64 * (1 + 2) + 9 * 64 * 64 + 8 * 64
    assert side == "bytes" and t == pytest.approx(max(ops / 1979e12, nbytes / 3.35e12), rel=1e-12)


def test_attention_bound_by_operations():
    layer = {x.name: x for x in work.model_layers(config("vit_b16_w4a8"))}["encoder_layer_0.attention"]
    assert layer.macs == 2 * 12 * 197 * 197 * 64
    t, side = work.bound_s(layer, 128, "f32", "float32", "float32", "float32")
    assert side == "operations" and t == pytest.approx(2 * 128 * layer.macs / 67e12, rel=1e-12)
