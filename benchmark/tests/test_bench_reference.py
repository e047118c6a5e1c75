"""The plain references against themselves and against independent float
forwards, at tiny sizes on the CPU."""
from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark.core import weights
from benchmark.reference import quant as Q
from benchmark.reference.resnet import ResNetReference
from benchmark.reference.vit import ViTReference

ROOT = Path(__file__).resolve().parents[2]


def config(name, **arch):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg["architecture"].update(arch)
    return cfg


def test_rounding_and_grids():
    s, z = torch.tensor([1.0]), torch.tensor([-2.0])
    x = torch.tensor([-5.0, 0.5, 1.5, 2.5, 300.0])
    # round half to even, then the asymmetric grid [0, 255] shifted by z
    assert Q.fq_act(x, s, z, 8).tolist() == [-2.0, 0.5 - 0.5, 2.0 - 0.0, 2.0, 253.0]
    w = torch.tensor([[1.0, -0.5, 0.25], [2.0, 0.0, -2.0]])
    q = Q.minmax_weight(w, 8, 0)
    assert torch.equal(q[1], w[1]) and (q - w).abs().max() <= 1.0 / 127 / 2 + 1e-7
    r = Q.ActRange(0.1)
    r.observe(torch.tensor([0.0, 4.0]))
    r.observe(torch.tensor([-1.0, 2.0]))
    assert r.lo.item() == pytest.approx(-0.1) and r.hi.item() == pytest.approx(3.8)


def test_mse_range_never_worse_than_minmax():
    w = torch.randn(16, 64, generator=torch.Generator().manual_seed(0)) ** 3
    err = lambda q: ((w - q).abs() ** 2.4).sum(dim=1)  # noqa: E731
    assert bool((err(Q.mse_weight(w, 4, 0)) <= err(Q.minmax_weight(w, 4, 0))).all())


def _torchvision_resnet(sd, arch, x):
    """An independent float forward with the BatchNorms unfolded."""
    def bn(t, k):
        return F.batch_norm(t, sd[f"{k}.running_mean"], sd[f"{k}.running_var"],
                            sd[f"{k}.weight"], sd[f"{k}.bias"], False, 0.0, 1e-5)

    x = F.relu(bn(F.conv2d(x, sd["conv1.weight"], None, 2, 3), "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n in enumerate(arch["stage_sizes"]):
        for b in range(n):
            p, s = f"layer{stage + 1}.{b}", 2 if stage > 0 and b == 0 else 1
            out = F.relu(bn(F.conv2d(x, sd[f"{p}.conv1.weight"]), f"{p}.bn1"))
            out = F.relu(bn(F.conv2d(out, sd[f"{p}.conv2.weight"], None, s, 1), f"{p}.bn2"))
            out = bn(F.conv2d(out, sd[f"{p}.conv3.weight"]), f"{p}.bn3")
            if f"{p}.downsample.0.weight" in sd:
                x = bn(F.conv2d(x, sd[f"{p}.downsample.0.weight"], None, s), f"{p}.downsample.1")
            x = F.relu(out + x)
    return F.linear(x.mean(dim=(2, 3)), sd["fc.weight"], sd["fc.bias"])


def _torchvision_vit(sd, arch, x):
    """An independent float forward through torch.nn.MultiheadAttention."""
    e, heads = arch["hidden_dim"], arch["num_heads"]
    mha = torch.nn.MultiheadAttention(e, heads, batch_first=True)
    x = F.conv2d(x, sd["conv_proj.weight"], sd["conv_proj.bias"], arch["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["class_token"].expand(len(x), 1, e), x], 1) + sd["encoder.pos_embedding"]
    for i in range(arch["num_layers"]):
        p = f"encoder.layers.encoder_layer_{i}"
        mha.load_state_dict({k[len(p) + 16:]: v for k, v in sd.items()
                             if k.startswith(f"{p}.self_attention.")})
        y = F.layer_norm(x, (e,), sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"], 1e-6)
        x = x + mha(y, y, y, need_weights=False)[0]
        y = F.layer_norm(x, (e,), sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"], 1e-6)
        y = F.linear(F.gelu(F.linear(y, sd[f"{p}.mlp.0.weight"], sd[f"{p}.mlp.0.bias"])),
                     sd[f"{p}.mlp.3.weight"], sd[f"{p}.mlp.3.bias"])
        x = x + y
    x = F.layer_norm(x[:, 0], (e,), sd["encoder.ln.weight"], sd["encoder.ln.bias"], 1e-6)
    return F.linear(x, sd["heads.head.weight"], sd["heads.head.bias"])


CASES = [
    ("resnet50_w8a8", ResNetReference, _torchvision_resnet,
     dict(stage_sizes=[1, 1, 1, 1], image_size=32, num_classes=10)),
    ("vit_b16_w4a8", ViTReference, _torchvision_vit,
     dict(num_layers=2, hidden_dim=32, num_heads=4, mlp_dim=64, patch_size=8, image_size=32,
          num_classes=10)),
]


@pytest.mark.parametrize("name, cls, plain, arch", CASES, ids=[c[0] for c in CASES])
def test_reference_float_path_and_precision_ladder(name, cls, plain, arch):
    torch.manual_seed(0)
    cfg = config(name, **arch)
    sd = weights.state_dict(cfg["family"], cfg["architecture"], 3, "cpu")
    gen = torch.Generator().manual_seed(1)
    calib = [torch.randn(4, 32, 32, 3, generator=gen) for _ in range(2)]
    x = torch.randn(6, 32, 32, 3, generator=gen)

    with torch.no_grad():
        want = plain(sd, cfg["architecture"], x.permute(0, 3, 1, 2))
        # before calibrate the reference runs the float network
        got = cls(sd, cfg["architecture"], cfg["quant"])._forward(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))

    ref = cls(sd, cfg["architecture"], cfg["quant"])
    ref.calibrate(calib)
    gaps = {}
    for bits in (16, 8, 4):
        # calibrated on x itself, so that no input is clipped
        low = cls(sd, cfg["architecture"], cfg["quant"], bits, bits)
        low.calibrate([x])
        gaps[bits] = float(((low.forward(x) - want).norm(dim=-1) / want.norm(dim=-1)).max())
    # the reference against itself: the same calibration gives the same bits
    again = cls(sd, cfg["architecture"], cfg["quant"])
    again.calibrate(calib)
    assert torch.equal(again.forward(x), ref.forward(x))
    assert gaps[16] < 1e-3 < gaps[8] < gaps[4]
