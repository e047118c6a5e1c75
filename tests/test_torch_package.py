"""Structure of the port (quantize_tpu_torch): it imports no JAX and nothing
of quantize_tpu, its entry points default to CUDA, and each kernel wrapper
runs its plain version on CPU tensors without counting a launch. The tests
marked ``cuda`` hold every kernel against its plain version on the card.

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
import quantize_tpu_torch.runners as runners
from quantize_tpu_torch import api, cli, deploy
from quantize_tpu_torch.models import MODELS, build_model
from quantize_tpu_torch.models.testnet import TestCNN, TrajNet
from quantize_tpu_torch.models.resnet import ResNet
from quantize_tpu_torch.models.vit import VisionTransformer
from quantize_tpu_torch.parallel import (InferenceEngine, PrefetchIterator, device_healthcheck,
                                         prefetch_to_mesh)
from quantize_tpu_torch.ops import _build, launch_counts, reset_launch_counts
from quantize_tpu_torch.ops.attention import mha_rows, mha_rows_int8
from quantize_tpu_torch.ops.layernorm import layernorm_quant_int8_rows, layernorm_rows
from quantize_tpu_torch.ops.qconv import kmajor_weight, qconv2d_int8
from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual_gemm
from quantize_tpu_torch.ops.qmatmul import (pack_int4_splithalf, quantize_act_int8, w4a8_gemm,
                                            w8a8_gemm, wo_gemm)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "quantize_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "tensorstore", "quantize_tpu")


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
    ported = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"cli.py", "data/base.py", "data/synthetic.py", "data/transforms.py",
            "models/testnet.py", "runners/base.py", "runners/ptq.py", "runners/__init__.py",
            "utils/log.py", "utils/meters.py", "models/clip/__init__.py", "models/clip/model.py",
            "models/clip/tokenizer.py", "models/clip/textfix.py",
            "models/clip/prompt_learning.py", "models/import_clip.py",
            "models/import_vit.py", "nn/qtensor.py", "checkpoint.py", "profiling.py",
            "parallel/__init__.py", "parallel/fault.py", "runners/resume.py", "ops/_cost.py",
            "utils/msgpack.py", "data/cifar.py", "data/imagenet.py", "parallel/mesh.py",
            "parallel/input_pipeline.py", "parallel/serving.py", "engine/__init__.py",
            "quant/pack.py"} <= ported
    for f in files:
        bad = [m for m in _imported_roots(f) if m in FORBIDDEN]
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    for fn in (api.init_model, api.calibrate_model, deploy.pack_model,
               MODELS.lookup("resnet50"), MODELS.lookup("resnet18"), MODELS.lookup("vit_b_16"),
               build_model, runners.build_runner, runners.execute_runner,
               device_healthcheck, InferenceEngine, PrefetchIterator, prefetch_to_mesh):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for cls in (ResNet, VisionTransformer, TestCNN, TrajNet, runners.BasicRunner):
        assert inspect.signature(cls).parameters["device"].default == "cuda", cls
    # the CLI passes --device down, cuda unless given
    seen = []
    monkeypatch.setattr(runners, "execute_runner", lambda cfg, device: seen.append(device))
    cfg_file = str(ROOT / "configs/runners/ptq/minmax/ptq_rn18_w8a8_synthetic.yaml")
    monkeypatch.chdir(ROOT)
    cli.main(["--cfg", cfg_file, "--output-dir", str(tmp_path)])
    cli.main(["--cfg", cfg_file, "--output-dir", str(tmp_path), "--device", "cpu"])
    assert seen == ["cuda", "cpu"]


def test_every_kernel_has_its_source_and_a_launch_counter():
    for lib in _build.LIBRARIES:
        src = PORT / "csrc" / f"{lib}.cu"
        text = src.read_text()
        assert "Replaces" in text and "extern \"C\"" in text, lib
    for name, (lib, sym, _) in _build.KERNELS.items():
        assert f"extern \"C\" int {sym}(" in (PORT / "csrc" / f"{lib}.cu").read_text(), name
    for fn in (w8a8_gemm, conv1x1_residual_gemm, qconv2d_int8, w4a8_gemm, layernorm_rows,
               layernorm_quant_int8_rows, mha_rows, wo_gemm, mha_rows_int8, quantize_act_int8):
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
    outs = _call_all(_kernel_args("cpu")) + _call_vit(_vit_kernel_args("cpu"))
    assert set(launch_counts()) == set(_build.KERNELS)
    assert all(n == 0 for n in launch_counts().values())
    assert [tuple(o.shape) for o in outs] == [(24, 16), (24, 16), (6, 2, 2, 16), (24, 16),
                                              (24, 32), (24, 32), (24, 32), (24, 32),
                                              (24, 16), (24, 16), (24, 32), (24, 32)]
    assert all(np.isfinite(o.float().numpy()).all() for o in outs)


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4, 5, 6, 7, 8, 9])
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
    v = _vit_kernel_args("meta")
    calls += [
        lambda: w4a8_gemm(v["q"], z, s, v["wp"], v["cs"], v["vec"], v["vec"], None, True),
        lambda: layernorm_rows(v["x"], v["gamma"], v["beta"], 1e-6, torch.float32),
        lambda: layernorm_quant_int8_rows(v["x"], v["gamma"], v["beta"], 1e-6, s, z, 0, 255),
        lambda: mha_rows(v["qkv"], 2, 8, False, torch.float32, 0),
        lambda: wo_gemm(v["x"], v["w8"], v["vec"], v["vec"], None, torch.bfloat16),
        lambda: mha_rows_int8(v["qkv"], 2, 8, False, torch.float32, 0),
        lambda: quantize_act_int8(v["x"], s, z, 0, 255),
    ]
    with pytest.raises(ValueError, match="unsupported device"):
        calls[which]()


def _vit_kernel_args(device):
    g = torch.Generator().manual_seed(1)
    q = torch.randint(-128, 128, (24, 32), generator=g).to(torch.int8)
    w4 = torch.randint(-8, 8, (32, 16), generator=g).to(torch.int8)
    x = torch.randn(24, 32, generator=g)
    out = dict(q=q, wp=pack_int4_splithalf(w4), cs=w4.sum(0, dtype=torch.int32), w8=w4,
               scalars=(torch.tensor(3.0), torch.tensor(0.01)), vec=torch.rand(16, generator=g),
               x=x, gamma=torch.rand(32, generator=g) + 0.5, beta=torch.randn(32, generator=g),
               qkv=torch.randn(24, 96, generator=g))
    return {k: (tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device))
            for k, v in out.items()}


def _call_vit(a):
    z, s = a["scalars"]
    return [
        w4a8_gemm(a["q"], z, s, a["wp"], a["cs"], a["vec"], a["vec"], a["vec"], False),
        layernorm_rows(a["x"], a["gamma"], a["beta"], 1e-6, torch.float32),
        layernorm_quant_int8_rows(a["x"], a["gamma"], a["beta"], 1e-6, s, z, 0, 255)[0],
        mha_rows(a["qkv"], 2, 8, False, torch.float32, 7),
        mha_rows(a["qkv"], 2, 8, True, torch.float32, 7),
        wo_gemm(a["x"], a["w8"], a["vec"], a["vec"], a["vec"], torch.float32),
        wo_gemm(a["x"].to(torch.bfloat16), a["w8"], a["vec"], a["vec"], None, torch.bfloat16),
        mha_rows_int8(a["qkv"], 2, 8, False, torch.float32, 7),
        mha_rows_int8(a["qkv"].to(torch.bfloat16), 2, 8, True, torch.bfloat16, 7),
    ]


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
    assert {k: launch_counts()[k] for k in ("w8a8_gemm", "conv1x1_residual", "qconv2d")} == \
        {"w8a8_gemm": 1, "conv1x1_residual": 1, "qconv2d": 1}
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


@pytest.mark.cuda
def test_cuda_scale_zero_is_a_true_division(cuda_card):
    """compute_scale_zero on the card equals the CPU's (and JAX's) true
    float32 division bit for bit; a division by a Python scalar would be
    a multiplication by the rounded reciprocal on CUDA."""
    from quantize_tpu_torch.quant.qspec import compute_scale_zero

    g = torch.Generator().manual_seed(0)
    xmin, xmax = -torch.rand(4096, generator=g) * 7, torch.rand(4096, generator=g) * 9
    for n_bits, symmetric, signed in ((8, True, True), (8, False, False), (4, True, True)):
        cpu = compute_scale_zero(xmin, xmax, n_bits, symmetric, signed)
        gpu = compute_scale_zero(xmin.cuda(), xmax.cuda(), n_bits, symmetric, signed)
        for a, b in zip(cpu, gpu):
            assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_cuda_hard_sigmoid_is_a_true_division(cuda_card):
    """MobileNetV3's hard sigmoid on the card equals the CPU's (and eager
    JAX's) true float32 division by 6 bit for bit over [-8, 8]; a division
    by a Python scalar would be a multiplication by the rounded reciprocal
    on CUDA."""
    from quantize_tpu_torch.models.mobilenet import hard_sigmoid, hard_swish

    x = torch.linspace(-8.0, 8.0, 1 << 20, dtype=torch.float32)
    x = torch.cat([x, torch.randn(1 << 16, generator=torch.Generator().manual_seed(6)) * 4])
    for fn in (hard_sigmoid, hard_swish):
        assert torch.equal(fn(x.cuda()).cpu(), fn(x))


def _assert_within_bf16_ulps(got, want, ulps):
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
    assert bool(((g - w).abs() <= ulps * ulp).all()), float((g - w).abs().max())


# (M, K, N): K/2 = 16, 20, 48 and 80 leave a tail past the 32-row mma.sync
# step or the 64-row wgmma stage; ViT-B/16's fused qkv, fc1, fc2 at batch 128
# and its head at M = 128 and 200; K = 40 and 200 take the mma.sync route
W4A8_SHAPES = [(24, 32, 16), (300, 96, 80), (1000, 768, 2304), (100, 40, 70), (130, 3072, 768),
               (25600, 768, 2304), (25600, 768, 3072), (25600, 3072, 768), (128, 768, 1000),
               (200, 768, 1000), (200, 160, 1000), (333, 96, 256), (200, 200, 1000)]


def _w4a8_args(m, k, n, wz0):
    g = torch.Generator().manual_seed(k)
    q = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-8, 8, (k, n), generator=g, dtype=torch.int8)
    args = [q, torch.tensor(131.5), torch.tensor(0.02), pack_int4_splithalf(w),
            w.sum(0, dtype=torch.int32), torch.rand(n, generator=g) * 0.01,
            torch.zeros(n) if wz0 else torch.randn(n, generator=g), torch.randn(n, generator=g)]
    return [t.cuda() for t in args]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", W4A8_SHAPES)
@pytest.mark.parametrize("wz0", [True, False])
def test_cuda_w4a8_kernel_is_bit_equal_to_its_plain_version(cuda_card, shape, wz0):
    """K4 on the card: exact integer sums and the same epilogue, so equal
    bit for bit, on the route its shape selects (K a multiple of 32: the
    wgmma kernel, the wrapper making the K-major copy)."""
    from quantize_tpu_torch.ops.qmatmul import w4a8_gemm_plain

    m, k, n = shape
    args = _w4a8_args(m, k, n, wz0)
    reset_launch_counts()
    got = w4a8_gemm(*args, wz0)
    want = w4a8_gemm_plain(*args, wz0)
    torch.cuda.synchronize()
    route = "wgmma" if k % 32 == 0 else "mma_sync"
    assert w4a8_gemm.route_launches == {"wgmma": 0, "mma_sync": 0, route: 1}
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("given", ["w_km only", "both", "misaligned A"])
def test_cuda_w4a8_routes_by_shape_and_alignment(cuda_card, given):
    """The K-major copy alone, or beside the packed weight, takes the wgmma
    route; an A that is not 16-byte aligned takes the mma.sync route (the
    wrapper makes the packed weight from the copy); every one bit-equal."""
    from quantize_tpu_torch.ops.qmatmul import kmajor_packed, w4a8_gemm_plain

    m, k, n = 200, 768, 1000
    args = _w4a8_args(m, k, n, False)
    w_km = kmajor_packed(args[3])
    want = w4a8_gemm_plain(*args, False)
    if given == "misaligned A":
        buf = torch.empty(m * k + 1, dtype=torch.int8, device="cuda")
        args[0] = buf[1:].view(m, k).copy_(args[0])
    if given != "both":
        args[3] = None
    reset_launch_counts()
    got = w4a8_gemm(*args, False, w_km)
    torch.cuda.synchronize()
    route = "mma_sync" if given == "misaligned A" else "wgmma"
    assert w4a8_gemm.route_launches == {"wgmma": 0, "mma_sync": 0, route: 1}
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 768, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_layernorm_kernels_match_their_plain_versions(cuda_card, d, dtype):
    """K6 and K7 on the card: float64 row sums and IEEE 1/sqrt, so equal to
    the plain versions bit for bit (K6 in f32 and bf16, K7's int8)."""
    from quantize_tpu_torch.ops.layernorm import layernorm_plain, layernorm_quant_int8_plain

    g = torch.Generator().manual_seed(d)
    x = (torch.randn(517, d, generator=g) * 3 + 0.5).to(dtype).cuda()
    gamma, beta = (torch.rand(d, generator=g) + 0.5).cuda(), torch.randn(d, generator=g).cuda()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = layernorm_rows(x, gamma, beta, 1e-6, out_dtype)
        torch.testing.assert_close(got, layernorm_plain(x, gamma, beta, 1e-6, out_dtype),
                                   rtol=0, atol=0)
    a_s, a_z = torch.tensor(0.04).cuda(), torch.tensor(-100.0).cuda()
    for qmin, qmax in ((0, 255), (-128, 127)):
        q, z = layernorm_quant_int8_rows(x, gamma, beta, 1e-6, a_s, a_z, qmin, qmax)
        q_p, z_p = layernorm_quant_int8_plain(x, gamma, beta, 1e-6, a_s, a_z, qmin, qmax)
        torch.cuda.synchronize()
        assert torch.equal(q, q_p) and float(z) == float(z_p)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,valid,causal", [(2, 200, 12, 64, 197, False),
                                                  (3, 24, 2, 16, 17, True),
                                                  (2, 77, 4, 80, 0, True),
                                                  (1, 300, 2, 64, 0, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_kernel_matches_its_plain_version(cuda_card, b, s, h, d, valid, causal,
                                                         dtype):
    """K8 on the card: f32 within rtol 1e-4 / atol 1e-5 (summation order of
    the q.k and ex.v products), bf16 within two bf16 ulps."""
    from quantize_tpu_torch.ops.attention import mha_rows_plain

    g = torch.Generator().manual_seed(s)
    qkv = (torch.randn(b * s, 3 * h * d, generator=g) * 2).to(dtype).cuda()
    got = mha_rows(qkv, h, s, causal, dtype, valid)
    want = mha_rows_plain(qkv, h, s, causal, dtype, valid)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        _assert_within_bf16_ulps(got, want, 2)


def _assert_within_sum_order(got, want, x, w_int, w_scale, w_zero, bias, compute_dtype):
    """K5 against its plain version: the same float32 products summed in
    another order, held per output at every K to |diff| <= 2^-18 * sum|a*w|
    + 2^-23 * |out| (the second term is the rounding of acc + bias). The
    control, the product of an f32 activation left unrounded (a kernel that
    skipped A's rounding to ``compute_dtype``), must fall outside it."""
    from quantize_tpu_torch.ops.qmatmul import _dequant_weight

    w = _dequant_weight(w_int, w_scale, w_zero).to(compute_dtype).float()
    sum_abs = x.to(compute_dtype).float().abs() @ w.abs()
    limit = 2.0 ** -18 * sum_abs + 2.0 ** -23 * want.abs()
    assert bool(((got - want).abs() <= limit).all()), float(((got - want).abs() / limit).max())
    if x.dtype != compute_dtype:
        control = x.float() @ w + (0 if bias is None else bias)
        assert bool(((control - want).abs() > limit).any())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 32, 16), (300, 96, 80), (256, 768, 1000),
                                   (100, 40, 70), (130, 3072, 768), (14336, 768, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wo_kernel_matches_its_plain_version(cuda_card, shape, dtype):
    """K5 on the card, f32 and bf16 activations, ragged M, N and K (K = 40
    and N = 70 take the byte-wise loaders), with and without a bias."""
    from quantize_tpu_torch.ops.qmatmul import wo_gemm_plain

    m, k, n = shape
    g = torch.Generator().manual_seed(k + n)
    x = (torch.randn(m, k, generator=g) * 2).to(dtype)
    w = torch.randint(-8, 8, (k, n), generator=g, dtype=torch.int8)
    w_s, w_z = torch.rand(n, generator=g) * 0.01, torch.randn(n, generator=g)
    for bias in (torch.randn(n, generator=g), None):
        args = [t if t is None else t.cuda() for t in (x, w, w_s, w_z, bias)]
        got = wo_gemm(*args, torch.bfloat16)
        want = wo_gemm_plain(*args, torch.bfloat16)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        _assert_within_sum_order(got, want, *args, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 127, 14337])
@pytest.mark.parametrize("n", [8, 1000, 3080])
@pytest.mark.parametrize("k", [40, 3072])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wo_kernel_at_ragged_tile_edges(cuda_card, m, n, k, dtype):
    """K5 where its 128 x 128 output tile and 64-deep K stage do not divide
    the shape: M = 1, 127 and 14,337, N = 8, 1000 and 3,080 (the weight's
    rows are then not 16-byte aligned, so the plain-load producer runs),
    K = 40 and 3,072. Each output within the per-element limit."""
    from quantize_tpu_torch.ops.qmatmul import wo_gemm_plain

    g = torch.Generator().manual_seed(m + n + k)
    x = (torch.randn(m, k, generator=g) * 2).to(dtype).cuda()
    w = torch.randint(-8, 8, (k, n), generator=g, dtype=torch.int8).cuda()
    w_s, w_z = (torch.rand(n, generator=g) * 0.01).cuda(), torch.randn(n, generator=g).cuda()
    bias = torch.randn(n, generator=g).cuda() if (m + n) % 2 else None
    got = wo_gemm(x, w, w_s, w_z, bias, torch.bfloat16)
    want = wo_gemm_plain(x, w, w_s, w_z, bias, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    _assert_within_sum_order(got, want, x, w, w_s, w_z, bias, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,valid,causal", [(4, 56, 12, 64, 50, False),
                                                  (2, 200, 12, 64, 197, False),
                                                  (3, 24, 2, 16, 17, True),
                                                  (2, 77, 4, 80, 0, True),
                                                  (1, 40, 2, 8, 33, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_attention_kernel_matches_its_plain_version(cuda_card, b, s, h, d, valid,
                                                              causal, dtype):
    """K9 on the card: bit-equal to its plain version but for ex8 flips
    (an exp rounding on a boundary moves one ex8 by one step and one row of
    one head by at most 2.05 * sv); at most 1e-3 of the (row, head) groups
    may differ. Pad rows carry non-zero values."""
    from quantize_tpu_torch.ops.attention import mha_rows_int8_plain

    g = torch.Generator().manual_seed(s + d)
    qkv = (torch.randn(b * s, 3 * h * d, generator=g) * 2).to(dtype).cuda()
    got = mha_rows_int8(qkv, h, s, causal, dtype, valid)
    want = mha_rows_int8_plain(qkv, h, s, causal, dtype, valid)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    diff = (got.float() - want.float()).abs().reshape(b, s, h, d).amax(-1)  # (B, S, H)
    sv = qkv.float().reshape(b, s, 3, h, d)[:, :, 2].abs().amax(dim=(1, 3)) / 127  # (B, H)
    assert int((diff > 0).sum()) <= max(2, 1e-3 * diff.numel())
    assert bool((diff <= 2.05 * sv[:, None, :] * (1 + 2.0 ** -7)).all())


@pytest.mark.cuda
def test_cuda_attention_dispatch_sends_odd_head_dims_to_the_oracle(cuda_card):
    """Head dim 12 (not a multiple of 8): the JAX package's dispatch runs
    its float32 oracle, and so does the port on the card: no K8 or K9
    launch."""
    from quantize_tpu_torch.ops.attention import mha_fused_qkv_rows, mha_oracle_rows

    qkv = torch.randn(2 * 24, 3 * 24, generator=torch.Generator().manual_seed(0))
    qkv = qkv.to(torch.bfloat16).cuda()
    reset_launch_counts()
    for int8 in (False, True):
        got = mha_fused_qkv_rows(qkv, 2, 24, valid_len=19, int8_scores=int8)
        assert torch.equal(got, mha_oracle_rows(qkv, 2, 24, False, torch.bfloat16, 19))
    torch.cuda.synchronize()
    assert launch_counts()["mha_rows"] == 0 and launch_counts()["mha_rows_int8"] == 0


def test_public_api_surface():
    for name in ("MODELS", "QuantCtx", "init_model", "calibrate_model", "pack_model",
                 "model_size_bytes", "fused_residual", "packed_carry", "execute_runner",
                 "Config"):
        assert hasattr(qtt, name), name


def test_kmajor_weight_is_the_transposed_kernel_made_once():
    """K3 reads the HWIO kernel as (Co, KH*KW*Ci) rows, Ci zero-padded to a
    multiple of 16. A packed QuantConv makes that copy once, when its weight
    is packed or loaded, as a buffer outside the packed collection (for the
    space-to-depth stem, of the rewritten weight); forwards reuse it and a
    new weight replaces it."""
    from quantize_tpu_torch.nn.layers import LayerQuantCfg, QuantConv
    from quantize_tpu_torch.ops.qconv import s2d_kernel

    g = torch.Generator().manual_seed(5)
    w = torch.randint(-128, 128, (3, 3, 16, 24), generator=g).to(torch.int8)
    w_km = kmajor_weight(w)
    assert w_km.shape == (24, 144) and w_km.is_contiguous()
    for kh, kw, ci, co in ((0, 0, 0, 0), (2, 1, 15, 23), (1, 2, 7, 5)):
        assert int(w_km[co, (kh * 3 + kw) * 16 + ci]) == int(w[kh, kw, ci, co])
    # Ci = 12 (the space-to-depth stem) pads to 16 channels of zeros
    w12 = torch.randint(-128, 128, (4, 4, 12, 64), generator=g).to(torch.int8)
    w_km = kmajor_weight(w12).reshape(64, 4, 4, 16)
    assert torch.equal(w_km[..., :12], w12.permute(3, 0, 1, 2)) and not w_km[..., 12:].any()

    quant = LayerQuantCfg(
        weight={"n_bits": 8, "symmetric": True, "granularity": "channel",
                "range": {"name": "minmax"}},
        activation={"n_bits": 8, "symmetric": False, "range": {"name": "minmax"}})
    conv = QuantConv(3, 8, (7, 7), (2, 2), padding=[(3, 3), (3, 3)], quant=quant, s2d=True,
                     device="cpu")
    conv.init_params(g)
    x = torch.randn((2, 16, 16, 3), generator=g)
    with torch.no_grad():
        conv(x, mode="calibrate")
        conv(x, mode="pack")
        w_int = conv.get_var("packed", "w_int")
        assert torch.equal(conv.w_kmajor, kmajor_weight(w_int))
        assert torch.equal(conv.w_s2d_kmajor, kmajor_weight(s2d_kernel(w_int)))
        assert "w_kmajor" not in conv.state_dict()
        assert not any("kmajor" in leaf for _, leaf, _ in conv.own_vars())
        made = conv.w_s2d_kmajor
        out = conv(x, mode="packed")
        assert conv.w_s2d_kmajor is made
        assert torch.equal(conv(x, mode="packed"), out)
        conv.put_var("packed", "w_int", w_int.neg())
        assert torch.equal(conv.w_kmajor, kmajor_weight(w_int.neg()))
        assert torch.equal(conv.w_s2d_kmajor, kmajor_weight(s2d_kernel(w_int.neg())))


# -- KQ, the activation quantize, on the card --------------------------------

KQ_SHAPES = [((32, 224, 224, 3), torch.float32), ((32, 56, 56, 256), torch.float32),
             ((32, 7, 7, 2048), torch.bfloat16), ((32, 2048), torch.float32),
             ((25600, 3072), torch.float32), ((25600, 3072), torch.bfloat16),
             ((1,), torch.float32), ((17,), torch.bfloat16), ((1000003,), torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", KQ_SHAPES)
@pytest.mark.parametrize("qmin,qmax", [(0, 255), (-128, 127)])
def test_cuda_activation_quantize_is_bit_equal_to_its_plain_version(cuda_card, shape, dtype,
                                                                    qmin, qmax):
    """KQ at ResNet-50 (batch 32) and ViT-B/16 (batch 128, fc2 input) shapes
    and odd lengths (the masked tail), values spread past both ends of the
    grid and placed on its half-integers: every int8 value and z_eff equal."""
    from quantize_tpu_torch.ops.qmatmul import quantize_act_int8_plain

    g = torch.Generator(device="cuda").manual_seed(len(shape))
    scale = torch.tensor(0.037, device="cuda")
    zero = torch.tensor(-97.0 if qmin >= 0 else 3.0, device="cuda")
    x = torch.randn(shape, generator=g, device="cuda") * 6
    half = (torch.randint(-140, 140, shape, generator=g, device="cuda") + 0.5 + zero) * scale
    x = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.25, half, x).to(dtype)
    reset_launch_counts()
    q, z_eff = quantize_act_int8(x, scale, zero, qmin, qmax)
    q_p, z_p = quantize_act_int8_plain(x, scale, zero, qmin, qmax)
    torch.cuda.synchronize()
    assert launch_counts()["quantize_act_int8"] == 1
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert int((q != q_p).sum()) == 0
    assert float(z_eff) == float(z_p)


@pytest.mark.cuda
def test_cuda_activation_quantize_unaligned_and_without_host_sync(cuda_card):
    """A view that starts off a 16-byte boundary takes the kernel's
    one-value path, bit-equal too; with scale and zero on the device the
    call never synchronizes with the host."""
    from quantize_tpu_torch.ops.qmatmul import quantize_act_int8_plain

    g = torch.Generator(device="cuda").manual_seed(3)
    base = torch.randn(4099, generator=g, device="cuda") * 4
    x = base[3:]
    scale, zero = torch.tensor(0.02, device="cuda"), torch.tensor(-128.0, device="cuda")
    quantize_act_int8(x, scale, zero, 0, 255)  # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q, _ = quantize_act_int8(x, scale, zero, 0, 255)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(q, quantize_act_int8_plain(x, scale, zero, 0, 255)[0])


# -- K3 at ResNet-50's conv shapes ----------------------------------------------

# (N, H, W, Ci), (KH, KW, Co), strides, padding: every ResNet-50 conv class,
# then ragged cases
K3_SHAPES = {
    "stem_s2d_ci12": ((4, 112, 112, 12), (4, 4, 64), (1, 1), ((2, 1), (2, 1))),
    "1x1_s1": ((4, 56, 56, 256), (1, 1, 64), (1, 1), "SAME"),
    "3x3_s1": ((4, 56, 56, 64), (3, 3, 64), (1, 1), "SAME"),
    "3x3_s1_c256": ((4, 14, 14, 256), (3, 3, 256), (1, 1), "SAME"),
    "3x3_s2": ((4, 56, 56, 128), (3, 3, 128), (2, 2), "SAME"),
    "downsample_1x1_s2": ((4, 56, 56, 256), (1, 1, 512), (2, 2), "SAME"),
    "1x1_c2048": ((4, 7, 7, 512), (1, 1, 2048), (1, 1), "SAME"),
    "co1000": ((3, 9, 11, 64), (3, 3, 1000), (1, 1), "SAME"),
    "patch_ci3": ((2, 224, 224, 3), (16, 16, 768), (16, 16), "VALID"),
    "ci16_co24": ((3, 10, 10, 16), (3, 3, 24), (2, 2), ((1, 1), (1, 1))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K3_SHAPES))
@pytest.mark.parametrize("wz0,out_dtype", [(True, torch.float32), (True, torch.bfloat16),
                                           (False, torch.float32)])
def test_cuda_qconv2d_is_bit_equal_to_its_plain_version(cuda_card, case, wz0, out_dtype):
    """K3 against its plain version, bit for bit (at Ci 12 and 3 too, whose
    channels the wrapper zero-pads to 16): exact int32 sums and the same
    epilogue, with z_w = 0 (ResNet-50's weights) or not (its count uses the
    real Ci), f32 or bf16 out."""
    from quantize_tpu_torch.ops.qconv import (conv_zero_correction_map, qconv2d_int8_plain,
                                              resolve_padding)

    (n, h, w_sp, ci), (kh, kw, co), strides, padding = K3_SHAPES[case]
    g = torch.Generator(device="cuda").manual_seed(len(case))
    q = torch.randint(-128, 128, (n, h, w_sp, ci), generator=g, device="cuda").to(torch.int8)
    w = torch.randint(-128, 128, (kh, kw, ci, co), generator=g, device="cuda").to(torch.int8)
    pads = resolve_padding(padding, kh, kw, h, w_sp, strides)
    corr = conv_zero_correction_map(w, h, w_sp, strides, pads)
    f = dict(device="cuda")
    z_eff, a_scale = torch.tensor(131.0, **f), torch.tensor(0.021, **f)
    w_scale = torch.rand(co, generator=g, **f) * 1e-3
    w_zero = torch.zeros(co, **f) if wz0 else torch.randint(-3, 4, (co,), generator=g, **f).float()
    bias = torch.randn(co, generator=g, **f)
    args = (q, z_eff, a_scale, w, w_scale, w_zero, bias, strides, pads, corr, wz0, out_dtype)
    reset_launch_counts()
    got = qconv2d_int8(*args)
    want = qconv2d_int8_plain(*args)
    torch.cuda.synchronize()
    assert launch_counts()["qconv2d"] == 1
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


# -- K2 on both of its routes -------------------------------------------------------

# (M, K, N, residual dtype, output dtype, relu, bias, route): ResNet-50's four
# tail shapes at batch 256, each carry; then ragged M (147 = 3 x 49 rows), N =
# 1000 (not a multiple of the 128-column tile), K = 48, mixed residual/output
# dtypes, no ReLU and no bias, and the mma.sync route (K = 40; N = 28 in bf16)
K2_CASES = [(m, k, n, dt, dt, True, True, "wgmma")
            for m, k, n in ((802816, 64, 256), (200704, 128, 512), (50176, 256, 1024),
                            (12544, 512, 2048))
            for dt in (torch.float32, torch.bfloat16)] + [
    (147, 256, 1024, torch.float32, torch.float32, True, True, "wgmma"),
    (147, 512, 1000, torch.bfloat16, torch.bfloat16, True, True, "wgmma"),
    (300, 48, 1000, torch.float32, torch.float32, True, True, "wgmma"),
    (147, 64, 256, torch.float32, torch.bfloat16, True, True, "wgmma"),
    (147, 64, 256, torch.bfloat16, torch.float32, True, True, "wgmma"),
    (49, 128, 512, torch.float32, torch.float32, False, False, "wgmma"),
    (300, 40, 256, torch.float32, torch.float32, True, True, "mma_sync"),
    (147, 64, 28, torch.bfloat16, torch.bfloat16, True, False, "mma_sync"),
]


def _k2_args(m, k, n, res_dtype, out_dtype, relu, with_bias):
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    f = dict(device="cuda")
    q = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8, **f)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8, **f)
    res = (torch.randn((m, n), generator=g, **f) * 4).to(res_dtype)
    return [q, torch.tensor(-57.25, **f), torch.tensor(0.0123, **f), w,
            w.sum(0, dtype=torch.int32), torch.rand(n, generator=g, **f) * 0.01,
            torch.randn(n, generator=g, **f) if with_bias else None, res, relu, out_dtype,
            w.t().contiguous()]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K2_CASES)
def test_cuda_conv1x1_residual_is_bit_equal_on_its_route(cuda_card, case):
    """K2 on the card against its plain version, bit for bit (exact int32
    sums, the same epilogue in the same rounding order), z_eff != 0, on the
    route its shape selects, given the K-major copy as the model gives it."""
    from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual_plain

    *shape, route = case
    args = _k2_args(*shape)
    reset_launch_counts()
    got = conv1x1_residual_gemm(*args)
    want = conv1x1_residual_plain(*args)
    torch.cuda.synchronize()
    assert conv1x1_residual_gemm.route_launches == {"wgmma": 0, "mma_sync": 0, route: 1}
    assert got.dtype == args[9] and got.shape == want.shape
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("given", ["no copy", "misaligned residual", "misaligned A"])
def test_cuda_conv1x1_residual_routes_by_operands(cuda_card, given):
    """The (K, N) weight without its K-major copy takes the wgmma route (the
    wrapper makes the copy); a residual or an A that is not 16-byte aligned
    takes the mma.sync route; every one bit-equal."""
    from quantize_tpu_torch.ops.qconv1x1 import conv1x1_residual_plain

    m, k, n = 300, 256, 1024
    args = _k2_args(m, k, n, torch.float32, torch.float32, True, True)
    want = conv1x1_residual_plain(*args)
    if given == "no copy":
        args[10] = None
    elif given == "misaligned residual":
        buf = torch.empty(m * n + 1, device="cuda")
        args[7] = buf[1:].view(m, n).copy_(args[7])
    else:
        buf = torch.empty(m * k + 1, dtype=torch.int8, device="cuda")
        args[0] = buf[1:].view(m, k).copy_(args[0])
    reset_launch_counts()
    got = conv1x1_residual_gemm(*args)
    torch.cuda.synchronize()
    route = "wgmma" if given == "no copy" else "mma_sync"
    assert conv1x1_residual_gemm.route_launches == {"wgmma": 0, "mma_sync": 0, route: 1}
    assert torch.equal(got, want)


# -- the runner's TestCNN on the card --------------------------------------------


class _Checking:
    """Stands in for a kernel wrapper under the names the port calls it by:
    runs the kernel and its plain version on the same arguments and asserts
    them bit-equal. The wrapper counts its launches on its module-level
    name, so ``launches`` (and the route counters) read and write the
    wrapper's own."""

    def __init__(self, name, kernel, plain, checked):
        self.name, self.kernel, self.plain, self.checked = name, kernel, plain, checked

    def __call__(self, *args):
        got, want = self.kernel(*args), self.plain(*args)
        torch.cuda.synchronize()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), self.name
        self.checked.append(self.name)
        return got

    def __getattr__(self, name):
        return getattr(self.kernel, name)

    @property
    def launches(self):
        return self.kernel.launches

    @launches.setter
    def launches(self, value):
        self.kernel.launches = value


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["testcnn", "trajnet"])
def test_cuda_testnet_packed_kernels_match_their_plain_versions(cuda_card, monkeypatch, name):
    """TestCNN and TrajNet W8A8 (the synthetic config's quant section), 10
    classes, 32 x 32, batch 64, packed on the card: every kernel call of a
    packed forward (K3 at Ci 3 and 16, K1 at N = 32 and the N = 10 head, KQ)
    is bit-equal to its plain version on the same arguments."""
    import quantize_tpu_torch.nn.layers as layers
    import quantize_tpu_torch.ops.qconv as qconv
    import quantize_tpu_torch.ops.qmatmul as qmatmul
    from quantize_tpu_torch.ops.qmatmul import quantize_act_int8_plain, w8a8_gemm_plain
    from quantize_tpu_torch.ops.qconv import qconv2d_int8_plain

    quant = {"default": {
        "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
                   "range": {"name": "minmax"}},
        "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                       "range": {"name": "maminmax", "momentum": 0.1}},
        "bn_folding": True}}
    model = MODELS.build(name, num_classes=10, ctx=qtt.QuantCtx(quant))
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((64, 32, 32, 3), generator=g, device="cuda")
    qtt.init_model(model, x, seed=1)
    qtt.calibrate_model(model, [torch.randn((64, 32, 32, 3), generator=g, device="cuda")])
    qtt.pack_model(model, x)
    checked = []
    kq = _Checking("quantize_act_int8", qmatmul.quantize_act_int8, quantize_act_int8_plain,
                   checked)
    for mod in (qmatmul, layers, qconv):
        monkeypatch.setattr(mod, "quantize_act_int8", kq)
    monkeypatch.setattr(qmatmul, "w8a8_gemm",
                        _Checking("w8a8_gemm", qmatmul.w8a8_gemm, w8a8_gemm_plain, checked))
    monkeypatch.setattr(qconv, "qconv2d_int8",
                        _Checking("qconv2d", qconv.qconv2d_int8, qconv2d_int8_plain, checked))
    reset_launch_counts()
    with torch.inference_mode():
        out = model(x, mode="packed")
    torch.cuda.synchronize()
    dense = 2 if name == "testcnn" else 1
    assert launch_counts() == {**{k: 0 for k in launch_counts()}, "qconv2d": 2,
                               "w8a8_gemm": dense, "quantize_act_int8": 2 + dense}
    assert sorted(checked) == sorted(["qconv2d"] * 2 + ["w8a8_gemm"] * dense
                                     + ["quantize_act_int8"] * (2 + dense))
    assert out.shape == (64, 10) and bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_cuda_imported_resnet18_into_scale_packed_kernels_match_their_plain_versions(
        cuda_card, monkeypatch):
    """ResNet-18 W8A8 from a torchvision-layout state dict
    (``tests/golden/weightgen.py``), BN folded into the weight quantizers'
    ``static_scale`` (``into_scale``), 10 classes, 64 x 64, batch 32,
    calibrated and packed on the card: every kernel call of a packed
    forward (K3 20: the space-to-depth stem, the 3 x 3 convs and the
    stride-2 1 x 1 downsample convs; K1 1; KQ 21) is bit-equal to its plain
    version, and the packed logits are within 2e-2 of max|quant logits|."""
    import json
    import sys

    import quantize_tpu_torch.nn.layers as layers
    import quantize_tpu_torch.ops.qconv as qconv
    import quantize_tpu_torch.ops.qmatmul as qmatmul
    from quantize_tpu_torch.ops.qconv import qconv2d_int8_plain
    from quantize_tpu_torch.ops.qmatmul import quantize_act_int8_plain, w8a8_gemm_plain

    sys.path.insert(0, str(ROOT / "tests" / "golden"))
    from weightgen import gen_param

    fixture = json.loads((ROOT / "tests" / "golden" / "models.json").read_text())
    names = next(c for c in fixture["cases"] if c["case"] == "resnet18_w8a8_intoscale")
    sd = {n: torch.from_numpy(gen_param(n, tuple(s))) for n, s in names["param_names"]}
    quant = {"default": {
        "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
                   "range": {"name": "minmax"}},
        "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                       "range": {"name": "minmax"}},
        "bn_folding": {"into_scale": True}}}
    model = MODELS.build("resnet18", num_classes=10, ctx=qtt.QuantCtx(quant))
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((32, 64, 64, 3), generator=g, device="cuda")
    qtt.init_model(model, x, torch_state_dict=sd, model_name="resnet18", into_scale=True)
    assert model.conv1.w_quantizer.has_var("qparams", "static_scale")
    qtt.calibrate_model(model, [torch.randn((32, 64, 64, 3), generator=g, device="cuda")])
    with torch.inference_mode():
        sim = model(x, mode="quant")
    qtt.pack_model(model, x)
    checked = []
    kq = _Checking("quantize_act_int8", qmatmul.quantize_act_int8, quantize_act_int8_plain,
                   checked)
    for mod in (qmatmul, layers, qconv):
        monkeypatch.setattr(mod, "quantize_act_int8", kq)
    monkeypatch.setattr(qmatmul, "w8a8_gemm",
                        _Checking("w8a8_gemm", qmatmul.w8a8_gemm, w8a8_gemm_plain, checked))
    monkeypatch.setattr(qconv, "qconv2d_int8",
                        _Checking("qconv2d", qconv.qconv2d_int8, qconv2d_int8_plain, checked))
    reset_launch_counts()
    with torch.inference_mode(), qtt.fused_residual(True):
        out = model(x, mode="packed")
    torch.cuda.synchronize()
    assert launch_counts() == {**{k: 0 for k in launch_counts()}, "qconv2d": 20,
                               "w8a8_gemm": 1, "quantize_act_int8": 21}
    assert sorted(checked) == sorted(["qconv2d"] * 20 + ["w8a8_gemm"] + ["quantize_act_int8"] * 21)
    assert out.shape == (32, 10) and bool(torch.isfinite(out).all())
    assert float((out - sim).abs().max() / sim.abs().max()) <= 2e-2
