"""Structure of the port (quantize_tpu_torch): it imports no JAX and nothing
of quantize_tpu, its entry points default to CUDA, and each kernel wrapper
runs its plain version on CPU tensors without counting a launch.

The import check reads the sources (AST), not ``sys.modules``: the test
process itself imports JAX.
"""
import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import quantize_tpu_torch as qtt
from quantize_tpu_torch import api, deploy
from quantize_tpu_torch.models import MODELS
from quantize_tpu_torch.models.resnet import ResNet
from quantize_tpu_torch.ops import _build, launch_counts, reset_launch_counts
from quantize_tpu_torch.ops.qconv import qconv2d_int8
from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual_gemm
from quantize_tpu_torch.ops.qmatmul import w8a8_gemm

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "quantize_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "quantize_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_quantize_tpu():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15 and all(f.exists() for f in files)
    for f in files:
        bad = [m for m in _imported_roots(f) if m in FORBIDDEN]
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_cuda():
    for fn in (api.init_model, api.calibrate_model, deploy.pack_model,
               MODELS.lookup("resnet50"), MODELS.lookup("resnet18")):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert inspect.signature(ResNet).parameters["device"].default == "cuda"


def test_every_kernel_has_its_source_and_a_launch_counter():
    for name in _build.KERNELS:
        src = PORT / "csrc" / f"{name}.cu"
        text = src.read_text()
        assert "Replaces" in text and "extern \"C\"" in text, name
    for fn in (w8a8_gemm, conv1x1_residual_gemm, qconv2d_int8):
        assert isinstance(fn.launches, int)
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "quantize_tpu_torch/_build/" in gitignore


def _kernel_args(device):
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-128, 128, (6, 2, 2, 32), generator=g).to(torch.int8)
    w = torch.randint(-128, 128, (1, 1, 32, 16), generator=g).to(torch.int8)
    f = dict(dtype=torch.float32)
    scalars = (torch.tensor(3.0, **f), torch.tensor(0.01, **f))  # z_eff, a_scale
    vec = torch.rand(16, generator=g)
    out = dict(q=q, w=w, scalars=scalars, vec=vec, res=torch.rand(24, 16, generator=g),
               corr=torch.zeros(1, 2, 2, 16), cs=w.reshape(32, 16).sum(0, dtype=torch.int32))
    return {k: (tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device))
            for k, v in out.items()}


def _call_all(a):
    z, s = a["scalars"]
    w2 = a["w"].reshape(32, 16)
    q2 = a["q"].reshape(24, 32)
    return [
        w8a8_gemm(q2, z, s, w2, a["cs"], a["vec"], a["vec"], a["vec"], False),
        conv1x1_residual_gemm(q2, z, s, w2, a["cs"], a["vec"], None, a["res"], True, torch.float32),
        qconv2d_int8(a["q"], z, s, a["w"], a["vec"], a["vec"], None, (1, 1), ((0, 0), (0, 0)),
                     a["corr"], False, torch.float32),
    ]


def test_cpu_tensors_take_the_plain_versions_without_counting():
    reset_launch_counts()
    outs = _call_all(_kernel_args("cpu"))
    assert launch_counts() == {"w8a8_gemm": 0, "conv1x1_residual": 0, "qconv2d": 0}
    assert [tuple(o.shape) for o in outs] == [(24, 16), (24, 16), (6, 2, 2, 16)]
    assert all(np.isfinite(o.numpy()).all() for o in outs)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_other_devices_raise_instead_of_falling_back(which):
    a = _kernel_args("meta")
    z, s = a["scalars"]
    w2, q2 = a["w"].reshape(32, 16), a["q"].reshape(24, 32)
    calls = [
        lambda: w8a8_gemm(q2, z, s, w2, a["cs"], a["vec"], a["vec"], None, True),
        lambda: conv1x1_residual_gemm(q2, z, s, w2, a["cs"], a["vec"], None, a["res"], True,
                                      torch.float32),
        lambda: qconv2d_int8(a["q"], z, s, a["w"], a["vec"], a["vec"], None, (1, 1),
                             ((0, 0), (0, 0)), a["corr"], True, torch.float32),
    ]
    with pytest.raises(ValueError, match="unsupported device"):
        calls[which]()


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the GPU machine)")


@pytest.mark.cuda
def test_cuda_kernels_match_their_plain_versions(cuda_card):
    from quantize_tpu_torch.ops.qconv import qconv2d_int8_plain
    from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual_plain
    from quantize_tpu_torch.ops.qmatmul import w8a8_gemm_plain

    a = _kernel_args("cuda")
    reset_launch_counts()
    got = _call_all(a)
    torch.cuda.synchronize()
    assert launch_counts() == {"w8a8_gemm": 1, "conv1x1_residual": 1, "qconv2d": 1}
    z, s = a["scalars"]
    w2, q2 = a["w"].reshape(32, 16), a["q"].reshape(24, 32)
    want = [
        w8a8_gemm_plain(q2, z, s, w2, a["cs"], a["vec"], a["vec"], a["vec"], False),
        conv1x1_residual_plain(q2, z, s, w2, a["cs"], a["vec"], None, a["res"], True, torch.float32),
        qconv2d_int8_plain(a["q"], z, s, a["w"], a["vec"], a["vec"], None, (1, 1),
                           ((0, 0), (0, 0)), a["corr"], False, torch.float32),
    ]
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4)


def test_public_api_surface():
    for name in ("MODELS", "QuantCtx", "init_model", "calibrate_model", "pack_model",
                 "model_size_bytes", "fused_residual", "packed_carry"):
        assert hasattr(qtt, name), name


def test_resnext_runs_float_modes_and_raises_in_packed_grouped_conv():
    ctx = qtt.QuantCtx({"default": {
        "weight": {"n_bits": 8, "symmetric": True, "granularity": "channel",
                   "range": {"name": "minmax"}},
        "activation": {"n_bits": 8, "symmetric": False, "range": {"name": "minmax"}},
        "bn_folding": True}})
    model = MODELS.build("resnext50_32x4d", num_classes=4, ctx=ctx, device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32)
    qtt.init_model(model, x, device="cpu")
    qtt.pack_model(model, x, device="cpu")
    with torch.no_grad():
        assert model(torch.from_numpy(x), mode="quant").shape == (1, 4)
        with pytest.raises(NotImplementedError, match="grouped"):
            model(torch.from_numpy(x), mode="packed")
