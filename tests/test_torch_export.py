"""Export (``quantize_tpu_torch.export``) held against the JAX package's
``quantize_tpu.export`` on the CPU, and the ``qtt`` custom ops.

Five small packed models, built from the same seeded numpy input and the
same JAX variables (JAX's init, calibrate and pack under ``jit``; the
port's ``export_forward`` is given JAX's deploy variables and loads them
with ``convert.from_jax_variables``):

* TestCNN W8A8 (batch 2, 16 x 16, 4 classes), as ``tests/test_export.py``;
* a two-stage bottleneck ResNet W8A8 with the fused tail (K2);
* a two-stage ResNeXt W8A8 (4 groups a grouped conv, K3g) with the fused tail;
* ``tests/test_torch_vit.py``'s two-layer ViT at hidden 128 W4A8 (K3, K4,
  K7, K8, K5 on the out-projection);
* the same ViT weight-only W4 under ``QTPU_ATTN_INT8=1`` (K6, K5, K9).

For each: the program that ``export_forward`` writes and ``load_exported``
reads back (here and in a fresh Python process) is bit-equal to the port's
eager packed forward; its graph holds one ``qtt`` node for each wrapper
call of the eager forward; its text mentions int8. Against JAX's own
exported forward (``jax.export``, so under ``jit``): the CNNs within JAX's
``rtol``/``atol`` of 1e-5 of ``tests/test_export.py`` (their epilogues are
float32 operations XLA contracts into FMAs, which moves no int8 rounding
at these sizes); the ViTs within ``tests/test_torch_vit.py``'s and
``tests/test_torch_weight_only.py``'s criteria, 1e-3 and 1e-4 of max|JAX
logits|, and with the same argmax.

An eager packed forward calls no ``qtt`` op; the loaded program calls one
for each node, and each op calls its wrapper once (on the CPU, the plain
version). The loaded int8-scores ViT runs without ``QTPU_ATTN_INT8`` set:
the trace fixed K9 in the program. ``tests/test_torch_export_ops.py`` checks the ops alone.
"""
import collections
import io
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from quantize_tpu.deploy import pack_model as jax_pack_model
from quantize_tpu.export import export_forward as jax_export_forward
from quantize_tpu.export import load_exported as jax_load_exported
from quantize_tpu.models import MODELS as JAX_MODELS
from quantize_tpu.models.resnet import ResNet as JaxResNet
from quantize_tpu.models.vit import VisionTransformer as JViT
from quantize_tpu.nn.intercept import QuantCtx as JaxQuantCtx
from quantize_tpu.nn.precision import fused_residual as jax_fused_residual
import quantize_tpu_torch as qtt
from quantize_tpu_torch.models.resnet import ResNet as PortResNet
from quantize_tpu_torch.models.vit import VisionTransformer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ACT = {"n_bits": 8, "symmetric": False, "granularity": "layer", "range": {"name": "minmax"}}
W8 = {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
      "range": {"name": "minmax"}}
W4 = dict(W8, n_bits=4)
W8A8 = {"default": {"weight": W8, "activation": ACT, "bn_folding": True}}
W4A8 = {"default": {"weight": W4, "activation": ACT, "bn_folding": True}}
WO4 = {"default": {"weight": {**W4, "range": {"name": "mse", "maxshrink": 0.8, "grid": 100}},
                   "activation": {"n_bits": 32}, "bn_folding": True}}
VIT = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2, hidden_dim=128, mlp_dim=256,
           num_classes=5)
RESNET = dict(stage_sizes=(1, 1), bottleneck=True, stem_width=16, num_classes=10)

# name: (JAX constructor, port constructor, config, input shape, environment,
#        limit of |port - JAX| as a share of max|JAX logits| (None: JAX's
#        rtol/atol 1e-5), the kernels the eager forward calls)
MODELS = {
    "testcnn": (lambda **a: JAX_MODELS.build("testcnn", num_classes=4, **a),
                lambda **a: qtt.MODELS.build("testcnn", num_classes=4, **a),
                W8A8, (2, 16, 16, 3), {}, None,
                {"qconv2d", "w8a8_gemm", "quantize_act_int8"}),
    "resnet": (lambda **a: JaxResNet(width_per_group=16, **RESNET, **a),
               lambda **a: PortResNet(width_per_group=16, **RESNET, **a),
               W8A8, (2, 32, 32, 3), {}, None,
               {"qconv2d", "conv1x1_residual", "w8a8_gemm", "quantize_act_int8"}),
    "resnext": (lambda **a: JaxResNet(groups=4, width_per_group=4, **RESNET, **a),
                lambda **a: PortResNet(groups=4, width_per_group=4, **RESNET, **a),
                W8A8, (2, 32, 32, 3), {}, None,
                {"qconv2d", "qconv2d_grouped", "conv1x1_residual", "w8a8_gemm",
                 "quantize_act_int8"}),
    "vit_w4a8": (lambda **a: JViT(**VIT, **a), lambda **a: VisionTransformer(**VIT, **a),
                 W4A8, (2, 32, 32, 3), {}, 1e-3,
                 {"qconv2d", "w4a8_gemm", "wo_gemm", "layernorm_quant_int8", "layernorm",
                  "mha_rows", "quantize_act_int8"}),
    "vit_wo_int8": (lambda **a: JViT(**VIT, **a), lambda **a: VisionTransformer(**VIT, **a),
                    WO4, (2, 32, 32, 3), {"QTPU_ATTN_INT8": "1"}, 1e-4,
                    {"wo_gemm", "layernorm", "mha_rows_int8"}),
}

# every module-level name a packed forward calls a kernel wrapper by
SITES = {
    "w8a8_gemm": [("quantize_tpu_torch.ops.qmatmul", "w8a8_gemm")],
    "w4a8_gemm": [("quantize_tpu_torch.ops.qmatmul", "w4a8_gemm")],
    "wo_gemm": [("quantize_tpu_torch.ops.qmatmul", "wo_gemm")],
    "quantize_act_int8": [("quantize_tpu_torch.ops.qmatmul", "quantize_act_int8"),
                          ("quantize_tpu_torch.nn.layers", "quantize_act_int8"),
                          ("quantize_tpu_torch.ops.qconv", "quantize_act_int8")],
    "qconv2d": [("quantize_tpu_torch.ops.qconv", "qconv2d_int8")],
    "qconv2d_grouped": [("quantize_tpu_torch.ops.qconv", "qconv2d_grouped_int8")],
    "conv1x1_residual": [("quantize_tpu_torch.ops.qconv1x1", "conv1x1_residual_gemm")],
    "layernorm": [("quantize_tpu_torch.ops.layernorm", "layernorm_rows")],
    "layernorm_quant_int8": [("quantize_tpu_torch.ops.layernorm", "layernorm_quant_int8_rows")],
    "mha_rows": [("quantize_tpu_torch.ops.attention", "mha_rows")],
    "mha_rows_int8": [("quantize_tpu_torch.ops.attention", "mha_rows_int8")],
}


CONV_OPS = ("qtt::qconv2d", "qtt::qconv2d_grouped", "qtt::conv1x1_residual")


@contextmanager
def wrapper_calls():
    """Count the calls of each kernel wrapper by its ``KERNEL_WRAPPERS``
    name, under every module-level name the port calls it by."""
    counts = collections.Counter()
    saved = []
    for name, sites in SITES.items():
        for mod_name, attr in sites:
            mod = sys.modules[mod_name]
            orig = getattr(mod, attr)
            saved.append((mod, attr, orig))

            def counting(*args, _orig=orig, _name=name, **kw):
                counts[_name] += 1
                return _orig(*args, **kw)

            setattr(mod, attr, counting)
    try:
        yield counts
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


class OpCalls(TorchDispatchMode):
    """Counts the ``qtt`` ops that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "qtt":
            self.counts[func._schema.name.split("::")[1]] += 1
        return func(*args, **(kwargs or {}))


def qtt_nodes(graph) -> collections.Counter:
    """``qtt`` op nodes of an FX graph by op name."""
    return collections.Counter(
        n.target._schema.name.split("::")[1] for n in graph.nodes
        if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
        and n.target.namespace == "qtt")


@contextmanager
def environment(env):
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _build(name, seed):
    jax_ctor, port_ctor, cfg, shape, env, _, _ = MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x_cal = rng.normal(size=shape).astype(np.float32)
    xj = jnp.asarray(x)
    jm = jax_ctor(ctx=JaxQuantCtx(cfg))
    v = dict(jax.jit(lambda k, a: jm.init(k, a, mode="calibrate"))(jax.random.PRNGKey(0),
                                                                    jnp.asarray(x_cal)))
    v.pop("taps", None)
    deploy = jax.device_get(jax.jit(lambda v, a: jax_pack_model(jm, v, a))(v, xj))
    tm = port_ctor(ctx=qtt.QuantCtx(cfg), device="cpu")
    xt = torch.from_numpy(x)
    out = {"x": xt}
    with environment(env), jax_fused_residual(True), qtt.fused_residual(True):
        out["jax"] = np.asarray(jax_load_exported(jax_export_forward(jm, deploy, xj))(xj))
        out["payload"] = qtt.export_forward(tm, deploy, xt)
        out["text"] = qtt.export_mlir_text(tm, None, xt)
        with torch.no_grad(), wrapper_calls() as calls, OpCalls() as eager_ops:
            out["eager"] = tm(xt, mode="packed")
        out["calls"], out["eager_ops"] = dict(calls), dict(eager_ops.counts)
    loaded = qtt.load_exported(out["payload"])
    out["nodes"] = qtt_nodes(loaded.graph)
    # the conv kernels' own weight copy (last argument) of each node
    out["copies"] = [n.args[-1] for n in loaded.graph.nodes if n.op == "call_function"
                     and getattr(n.target, "namespace", None) == "qtt"
                     and n.target._schema.name in CONV_OPS]
    # outside the environment: the trace fixed QTPU_ATTN_INT8 in the program
    with torch.no_grad(), wrapper_calls() as calls, OpCalls() as loaded_ops:
        out["loaded"] = loaded(xt)
    out["loaded_calls"], out["loaded_ops"] = dict(calls), dict(loaded_ops.counts)
    out["state"] = [t for t in (*loaded.state_dict().values(), *loaded.buffers())]
    return out


@pytest.fixture(scope="module")
def cases():
    return {name: _build(name, seed) for seed, name in enumerate(MODELS)}


@pytest.fixture(scope="module")
def fresh_process(cases, tmp_path_factory):
    """Each payload loaded and run by a new Python process that imports
    ``quantize_tpu_torch``: its outputs by model."""
    tmp = tmp_path_factory.mktemp("export")
    for name, case in cases.items():
        (tmp / f"{name}.pt2").write_bytes(case["payload"])
        torch.save(case["x"], tmp / f"{name}.x")
    script = (
        "import sys, torch\n"
        "import quantize_tpu_torch as qtt\n"
        "from pathlib import Path\n"
        "tmp = Path(sys.argv[1])\n"
        "torch.set_grad_enabled(False)\n"
        "for name in sys.argv[2:]:\n"
        "    f = qtt.load_exported((tmp / f'{name}.pt2').read_bytes())\n"
        "    torch.save(f(torch.load(tmp / f'{name}.x')), tmp / f'{name}.out')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]))
    subprocess.run([sys.executable, "-c", script, str(tmp), *cases], check=True, env=env,
                   cwd=REPO, timeout=300)
    return {name: torch.load(tmp / f"{name}.out") for name in cases}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loaded_program_is_bit_equal_to_eager(cases, name):
    case = cases[name]
    assert case["loaded"].dtype == case["eager"].dtype
    assert torch.equal(case["loaded"], case["eager"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loaded_program_matches_jax_export(cases, name):
    case = cases[name]
    got, want = case["loaded"].float().numpy(), case["jax"].astype(np.float32)
    assert got.shape == want.shape
    limit = MODELS[name][5]
    if limit is None:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.max(np.abs(got - want)) <= limit * np.max(np.abs(want))
        assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_qtt_node_per_wrapper_call(cases, name):
    case = cases[name]
    calls = {k: v for k, v in case["calls"].items() if v}
    assert set(calls) == MODELS[name][6]
    assert dict(case["nodes"]) == calls
    # the loaded program runs each node once, through the dispatcher, and
    # each op reaches its wrapper by the wrapper's module-level name
    assert case["loaded_ops"] == calls
    assert {k: v for k, v in case["loaded_calls"].items() if v} == calls


@pytest.mark.parametrize("name", ["resnet", "resnext", "testcnn", "vit_w4a8"])
def test_conv_weight_copies_travel_in_the_program(cases, name):
    """Each K3, K3g and K2 node reads its layer's K-major (or grouped) copy
    of the weight from the program's own tensors, made at pack time, so a
    loaded program builds none."""
    copies = cases[name]["copies"]
    assert copies and all(isinstance(c, torch.fx.Node) and c.op in ("placeholder", "get_attr")
                          for c in copies)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eager_forward_calls_no_qtt_op(cases, name):
    assert cases[name]["eager_ops"] == {}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fresh_process_loads_the_program(cases, fresh_process, name):
    assert torch.equal(fresh_process[name], cases[name]["eager"])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_exported_text_mentions_int8(cases, name):
    text = cases[name]["text"]
    assert "i8[" in text and "torch.ops.qtt." in text


def test_payload_holds_what_the_forward_reads(cases):
    """The deploy tensors travel (the int8 weights, their K-major copies);
    a packed layer's float kernel, the observers and the sample input do
    not."""
    case = cases["resnet"]
    assert torch.export.load(io.BytesIO(case["payload"])).example_inputs is None
    loaded = qtt.load_exported(case["payload"])
    names = {n for n, _ in loaded.named_buffers()} | {n for n, _ in loaded.named_parameters()}
    names |= set(loaded.state_dict())
    flat = " ".join(sorted(names))
    assert "w_kmajor" in flat and "packed_w_int" in flat and "w_colsum" in flat
    assert "qobs" not in flat
    assert not any(n.endswith("layer1_0.conv2.kernel") for n in names)
