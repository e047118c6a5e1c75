"""Rehearsals of ``run.py`` on the CPU at a toy size (the port's plain
paths), the import check, the control, and the faults the comparison must
catch. The cells keep their widths; only the image size, the batch and the
calibration are cut, and the window lasts a second or two."""
from __future__ import annotations

import ast
import contextlib
import copy
import io
import json
import sys
from pathlib import Path

import pytest
import torch

from benchmark import control, run
from benchmark.core import check, program, spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# the serving driver's cell, out of BENCHMARK.json until its tail can hold a
# bound (PERF.md, Open questions): rehearsed here so that it stays sound
SERVE = "resnet50_w8a8.serve_open"
TRAIN = [c for c in CELLS if spec.load_cell(c).traffic["kind"] == "qat_steps"]
INFER = [c for c in CELLS if c not in TRAIN] + [SERVE]
TOY = {"offline": dict(batch=4, keep_every=2, keep_max=2, rows_per_kept=3),
       "serve_open": dict(batch=8, rate_img_per_s=60, pool=32, max_images=4,
                          compare_requests=3, grace_s=30),
       "qat_steps": dict(batch=4)}


def load(name: str) -> spec.Cell:
    if name != SERVE:
        return spec.load_cell(name)
    bench = ROOT / "benchmark"
    metrics = (("engine.dispatch_ms.serve", "ms/batch"), ("engine.fill.serve", "share"),
               ("idle_pct.serve", "%"))
    return spec.Cell(
        name=SERVE, chips=1,
        config=json.loads((bench / "configs" / "resnet50_w8a8.json").read_text()),
        traffic=json.loads((bench / "traffic" / "serve_open.json").read_text()),
        params={"limits": {"logit_row_gap": 0.1}},
        end_to_end=[{"name": "latency_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
        per_layer=[{"name": n, "unit": u} for n, u in metrics])


def toy(name: str) -> spec.Cell:
    cell = load(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["architecture"]["image_size"] = 32
    cell.config["calibration"] = {"batches": 2, "batch": 4}
    cell.traffic = {**cell.traffic, **TOY[cell.traffic["kind"]]}
    return cell


def rehearse(name: str, trace: int = 0, seed: int = 2 ** 31 + 11, seconds: float = 1.5):
    out = io.StringIO()
    torch.set_num_threads(2)
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], allow_cpu=True, cell=toy(name))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS + [SERVE])
def test_rehearsal(name, trace):
    # a training step on the CPU takes a second or two, and a traced run
    # needs a unit of work after 80% of its window: longer windows there
    line = rehearse(name, trace, seconds=(6.0 if name in TRAIN else 1.5) * (1 + 2 * trace))
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "compared"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    cell = load(name)
    want = cell.per_layer if trace else cell.end_to_end
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in want}
    for metric, v in line["metrics"].items():
        assert v["unit"] == {m["name"]: m["unit"] for m in want}[metric]
    assert list(line)[-1] == "compared"
    assert ("breakdown" in line) == bool(trace)
    # the harness's own imports: none of JAX or of the JAX package
    assert run.forbidden_modules() == []


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc == 3 and capsys.readouterr().out == ""


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert "quantize_tpu_torch" not in _imports(path), path
        assert "quantize_tpu_torch" not in path.read_text()


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "quantize_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def _fails(cell, device) -> None:
    limits = cell.params["limits"]
    for reading, numbers in control.control_readings(cell, 5, device).items():
        if reading == "tf32":
            continue  # reads as sound runs do (PERF.md): not a control
        assert any(v > limits[k] for k, v in numbers.items()), (reading, numbers)


@pytest.mark.parametrize("name", CELLS + [SERVE])
def test_the_control_fails_the_limit(name):
    _fails(toy(name), torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limit_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _fails(toy(name), torch.device("cuda", 0))


FAULTS = {
    # an answer altered where it is produced: every row's logits moved by one class
    "altered": lambda out: out.roll(1, dims=-1),
    # half of the batch left out: its rows never computed
    "half": lambda out: torch.cat([out[:len(out) // 2], torch.zeros_like(out[len(out) // 2:])]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", INFER)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    real = program.build_packed

    def build(*args, **kwargs):
        model = real(*args, **kwargs)
        forward = model.forward

        def broken(x, mode="fp32", **kw):
            out = forward(x, mode=mode, **kw)
            return FAULTS[fault](out) if mode == "packed" else out

        model.forward = broken
        return model

    monkeypatch.setattr(program, "build_packed", build)
    assert rehearse(name)["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_training_step_is_not_correct(name, fault, monkeypatch):
    from quantize_tpu_torch import optim
    from quantize_tpu_torch.runners import qat

    if fault == "unchanged":
        # a step that returns its state unchanged
        monkeypatch.setattr(optim.Optimizer, "step", lambda self, params, grads: None)
    else:
        # half of the batch left out, the mean taken over the rest
        real = qat.loss_and_grads

        def half(model, img, label, mesh=None):
            n = len(img) // 2
            loss, logits, grads = real(model, img[:n], label[:n], mesh)
            return loss, torch.cat([logits, logits]), grads

        monkeypatch.setattr(qat, "loss_and_grads", half)
    assert rehearse(name)["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_below_float32_is_not_correct(name, monkeypatch):
    """The program switching its float32 products and convs to a lower
    precision in its first step and leaving them so: here oneDNN's bfloat16
    on the CPU, TF32 on the card (``control.py --tf32-program``)."""
    from quantize_tpu_torch.runners import qat

    onednn = torch.backends.mkldnn
    saved = (onednn.matmul.fp32_precision, onednn.conv.fp32_precision)

    def lower():
        onednn.matmul.fp32_precision = onednn.conv.fp32_precision = "bf16"

    def restore():
        onednn.matmul.fp32_precision, onednn.conv.fp32_precision = saved

    lower()
    try:
        honoured = check.float32_errors("cpu")["f32_matmul_err"] > 1e-4
    finally:
        restore()
    if not honoured:
        pytest.skip("this CPU computes float32 in full whatever oneDNN is told")
    real = qat.QAT.train_step

    def step(self, *args, **kwargs):
        lower()
        return real(self, *args, **kwargs)

    monkeypatch.setattr(qat.QAT, "train_step", step)
    try:
        line = rehearse(name)
    finally:
        restore()
    limits = spec.load_cell(name).params["limits"]
    assert line["correct"] is False
    assert line["compared"]["f32_matmul_err"]["value"] > limits["f32_matmul_err"]
    assert line["compared"]["f32_conv_err"]["value"] > limits["f32_conv_err"]


def test_a_family_without_a_training_reference_is_refused():
    from benchmark.drivers import qat_steps

    with pytest.raises(ValueError, match="no training reference"):
        qat_steps._train_reference({"family": "resnet"})


def test_tf32_kernels_are_counted():
    summary = {"kernels": {
        "sm80_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x16": [0.1, 3],
        "cutlass_80_tensorop_s1688gemm_128x128_16x4_nn_align4": [0.1, 2],
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_ffma": [0.1, 5],
        "cutlass_80_simt_sgemm_128x64_8x5_nn_align1": [0.1, 7]}}
    assert check.tf32_launches(summary) == 5.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_on_the_card(name):
    """A short run of the cell as the driver makes it, in a process of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import subprocess

    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                           str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
