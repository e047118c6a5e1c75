"""Profiling in the port (``quantize_tpu_torch.profiling``), held against
the JAX package on the CPU.

* ``layer_costs`` counts the contractions JAX's counts, with its names,
  FLOPs, bytes and operand bits, one for one in program order: the cases of
  JAX's ``tests/test_profiling.py`` (a matmul, a SAME conv) and TestCNN
  and ResNet-18 (16 x 16 and 32 x 32, batch 2) in fp32 and quant mode, W8A8.
* Roofline classification and ``roofline_report`` as JAX's tests, and on
  the H100's entry.
* A packed forward counts each kernel wrapper's contraction under the
  kernel's name (the wrappers run their plain versions here, whose own
  ``aten`` calls are not counted again): TestCNN 2 K3 + 2 K1, ResNet-18 20
  K3 + 1 K1, the FLOPs of each equal to the fp32 forward's but for the
  space-to-depth stem (a 4 x 4 conv over 12 channels).
* ``trace`` writes a Chrome trace; ``Timer`` times.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.profiling import layer_costs as jax_layer_costs
import quantize_tpu_torch as qtt
from quantize_tpu_torch import convert, profiling
from quantize_tpu_torch.ops.qconv import conv_nhwc
from quantize_tpu_torch.profiling import OpCost, layer_costs, roofline_report

torch.set_num_threads(2)

W8A8 = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "minmax"}},
    "bn_folding": True}}


def _rows(costs):
    return [(c.name, c.flops, c.bytes, c.dtype_bits) for c in costs]


def test_matmul_flops_counted_as_jax():
    a, b = np.zeros((128, 256), np.float32), np.zeros((256, 64), np.float32)
    costs = layer_costs(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert len(costs) == 1 and costs[0].flops == 2 * 128 * 256 * 64
    assert _rows(costs) == _rows(jax_layer_costs(lambda x, y: x @ y, jnp.asarray(a),
                                                 jnp.asarray(b)))


def test_conv_flops_counted_as_jax():
    x, w = np.zeros((1, 8, 8, 4), np.float32), np.zeros((3, 3, 4, 16), np.float32)
    costs = layer_costs(lambda a, b: conv_nhwc(a, b, (1, 1), "SAME"),
                        torch.from_numpy(x), torch.from_numpy(w))
    assert len(costs) == 1 and costs[0].flops == 2 * (8 * 8 * 16) * (3 * 3 * 4)
    want = jax_layer_costs(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(x), jnp.asarray(w))
    assert _rows(costs) == _rows(want)


def test_roofline_classification():
    big_mm = OpCost("dot_general", flops=2 * 4096**3, bytes=3 * 4096 * 4096, dtype_bits=8)
    small = OpCost("dot_general", flops=2 * 64, bytes=1e9, dtype_bits=8)
    for chip in ("tpu_v5e", "h100_sxm"):
        assert big_mm.bound(chip) == "compute"
        assert small.bound(chip) == "memory"
    assert profiling.DEFAULT_CHIP == "h100_sxm"
    # the H100's peaks: int8 1,979 TOP/s, bf16 989 TFLOP/s, float32 67, 3.35 TB/s
    ops = 1979e12
    assert OpCost("k", ops, 0, 8).min_time_s() == 1.0
    assert OpCost("k", 989e12, 0, 16).min_time_s() == 1.0
    assert OpCost("k", 67e12, 0, 32).min_time_s() == 1.0
    assert OpCost("k", 0, 3.35e12, 8).min_time_s() == 1.0


def test_model_roofline_report():
    model = qtt.MODELS.build("testcnn", num_classes=4, device="cpu")
    x = torch.zeros((1, 16, 16, 3))
    rep = roofline_report(lambda i: model(i), x)
    assert rep["n_ops"] >= 4  # 2 convs + 2 denses
    assert rep["total_gflops"] > 0 and rep["speed_of_light_ms"] > 0


# name: image size
MODELS = {"testcnn": 16, "resnet18": 32}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_case(request):
    name = request.param
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, MODELS[name], MODELS[name], 3)).astype(np.float32)
    xj = jnp.asarray(x)
    jm = JAX_MODELS.build(name, num_classes=10, ctx=JaxQuantCtx(W8A8))
    v0 = dict(jax.jit(lambda k, a: jm.init(k, a, mode="calibrate"))(jax.random.PRNGKey(0), xj))
    v0.pop("taps", None)
    v0 = jax.device_get(v0)
    tm = qtt.MODELS.build(name, num_classes=10, ctx=qtt.QuantCtx(W8A8), device="cpu")
    convert.from_jax_variables(tm, v0)
    xt = torch.from_numpy(x)
    out = {"name": name}
    for mode in ("fp32", "quant"):
        out[mode] = (layer_costs(lambda i: tm(i, mode=mode), xt),
                     jax_layer_costs(lambda v, i: jm.apply(v, i, mode=mode), v0, xj))
    qtt.pack_model(tm, x, device="cpu")
    out["packed"] = layer_costs(lambda i: tm(i, mode="packed"), xt)
    return out


@pytest.mark.parametrize("mode", ["fp32", "quant"])
def test_layer_costs_match_jax(model_case, mode):
    mine, theirs = model_case[mode]
    assert len(mine) == len(theirs) >= 4
    assert _rows(mine) == _rows(theirs)


def test_packed_forward_counts_each_kernel_wrapper(model_case):
    packed = model_case["packed"]
    fp32, _ = model_case["fp32"]
    names = [c.name for c in packed]
    want = {"testcnn": ["qconv2d"] * 2 + ["w8a8_gemm"] * 2,
            "resnet18": ["qconv2d"] * 20 + ["w8a8_gemm"]}[model_case["name"]]
    assert names == want
    assert all(c.dtype_bits == 8 for c in packed)
    skip = 1 if model_case["name"] == "resnet18" else 0  # the space-to-depth stem
    assert [c.flops for c in packed[skip:]] == [c.flops for c in fp32[skip:]]
    # int8 operands: fewer bytes than the float32 forward's
    assert sum(c.bytes for c in packed) < sum(c.bytes for c in fp32)


def test_trace_writes_a_chrome_trace_and_timer_times(tmp_path):
    model = qtt.MODELS.build("testcnn", num_classes=4, device="cpu")
    x = torch.zeros((1, 16, 16, 3))
    with torch.no_grad(), profiling.trace(str(tmp_path / "trace")) as prof:
        model(x)
    assert prof is not None
    events = json.load(open(tmp_path / "trace" / profiling.TRACE_FILE))["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    t = profiling.Timer(lambda: model(x), warmup=1, iters=2)()
    assert t > 0
