"""The port's spans (``quantize_tpu_torch.profiling.span``) on the CPU.

* Off (no profiler): a packed TestCNN forward and a QAT step open no range
  and leave the span totals as they were; ``span()`` returns one shared
  no-op.
* On, under ``torch.profiler.profile``: ``qtt.forward.packed``, each
  residual block's ``qtt.block.<path>``, the kernel wrappers' ``qtt.op.*``
  and the QAT step's ``qtt.qat.*`` ranges are in the profiler's events, the
  four phases inside ``qat.step``; the totals count them.
* The session rule: a profiled call, unprofiled calls, then a profiled
  stretch leave the totals of the stretch alone.
* Totals from two threads add up; ``profiling.trace`` writes ``spans.json``.
"""
import json
import threading

import numpy as np
import pytest
import torch

import quantize_tpu_torch as qtt
from quantize_tpu_torch import ops, profiling, runners
from quantize_tpu_torch.models import span_model
from quantize_tpu_torch.models.vit import VisionTransformer
from quantize_tpu_torch.utils import Config, Logger, log

torch.set_num_threads(2)

W8A8 = {"default": {
    "weight": {"n_bits": 8, "symmetric": True, "signed": True, "granularity": "channel",
               "range": {"name": "minmax"}},
    "activation": {"n_bits": 8, "symmetric": False, "granularity": "layer",
                   "range": {"name": "maminmax", "momentum": 0.1}},
    "bn_folding": True}}
PHASES = ("qat.forward", "qat.backward", "qat.optimizer", "qat.readback")


@pytest.fixture(scope="module")
def packed():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 16, 16, 3)).astype(np.float32))
    model = qtt.MODELS.build("resnet18", num_classes=10, ctx=qtt.QuantCtx(W8A8), device="cpu")
    qtt.init_model(model, x, seed=0, device="cpu")
    qtt.calibrate_model(model, [x], device="cpu")
    qtt.pack_model(model, x, device="cpu")
    return model, x


@pytest.fixture(scope="module")
def testcnn():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 16, 16, 3)).astype(np.float32))
    model = qtt.MODELS.build("testcnn", num_classes=10, ctx=qtt.QuantCtx(W8A8), device="cpu")
    qtt.init_model(model, x, seed=0, device="cpu")
    qtt.calibrate_model(model, [x], device="cpu")
    qtt.pack_model(model, x, device="cpu")
    return model, x


@pytest.fixture(scope="module")
def qat(tmp_path_factory):
    """A QAT runner over TestCNN W8A8 after one calibration step, its
    optimizer built, and a batch. The process-wide logger is put back
    afterwards, for the next test file on this worker."""
    gen = torch.Generator().manual_seed(7)
    batch = {"img": torch.randn((4, 16, 16, 3), generator=gen),
             "label": torch.randint(0, 10, (4,), generator=gen)}
    out = str(tmp_path_factory.mktemp("qat_runner"))
    previous = log._logger
    Logger(out)
    cfg = Config({"seed": 0, "output_dir": out, "model": {"name": "testcnn", "num_classes": 10},
                  "runner": {"name": "qat", "verbose": False}, "quant": W8A8,
                  "optimizer": {"name": "adam", "lr": 1e-5}, "lr_scheduler": {"name": "constant"},
                  "train": {"calibrated_epoch": 1, "max_epoch": 1, "print_freq": 1000}})
    runner = runners.build_runner(cfg, device="cpu")
    runner.init_variables(batch)
    runner.train_step(batch, 0, 0, 1)
    runner.build_optim()
    runner.initialized = True
    yield runner, batch
    log._logger = previous


def _step(qat):
    runner, batch = qat
    return runner.train_step(batch, 1, 0, 1)


def _qtt_events(prof):
    return [e for e in prof.events() if e.name.startswith("qtt.")]


def test_off_span_is_the_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("forward.packed"), profiling.span("qat.step")
    assert a is b is profiling._NO_SPAN
    with a as entered:
        assert entered is a


@pytest.mark.parametrize("work", ["packed_forward", "qat_step"])
def test_off_records_nothing_and_opens_no_range(work, testcnn, qat, monkeypatch):
    opened = []
    real = profiling._RANGE

    def counting(*args, **kwargs):
        opened.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(profiling, "_RANGE", counting)
    before = profiling.span_totals()
    launches = dict(ops.launch_counts())
    if work == "packed_forward":
        model, x = testcnn
        with torch.no_grad():
            model(x, mode="packed")
    else:
        _step(qat)
    assert opened == []
    assert profiling.span_totals() == before
    assert ops.launch_counts() == launches  # the CPU runs the plain versions
    with torch.no_grad(), torch.profiler.profile():
        testcnn[0](testcnn[1], mode="packed")
    assert ("qtt.forward.packed",) in opened  # on: the same hook opens ranges


def test_packed_forward_ranges_under_the_profiler(packed):
    model, x = packed
    with torch.no_grad(), torch.profiler.profile() as prof:
        model(x, mode="packed")
    names = [e.name for e in _qtt_events(prof)]
    assert names.count("qtt.forward.packed") == 1
    blocks = sorted({n for n in names if n.startswith("qtt.block.")})
    assert blocks == sorted(f"qtt.block.layer{s}_{b}" for s in range(1, 5) for b in range(2))
    # ResNet-18 W8A8 packed: 20 K3 (stem, 16 3 x 3, 3 downsamples), 1 K1, and
    # KQ before each
    assert names.count("qtt.op.qconv2d") == 20 and names.count("qtt.op.w8a8_gemm") == 1
    assert names.count("qtt.op.quantize_act_int8") >= 20
    totals = profiling.span_totals()
    assert totals["forward.packed"][0] == 1 and totals["op.qconv2d"][0] == 20
    outer = totals["forward.packed"][1]
    assert 0 < sum(s for k, (_, s) in totals.items() if k.startswith("op.")) <= outer
    assert 0 < sum(s for k, (_, s) in totals.items() if k.startswith("block.")) <= outer
    # every kernel span lies inside the forward's
    fwd = next(e for e in _qtt_events(prof) if e.name == "qtt.forward.packed").time_range
    for e in _qtt_events(prof):
        if e.name.startswith("qtt.op."):
            assert fwd.start <= e.time_range.start <= e.time_range.end <= fwd.end


def test_vit_kernel_wrappers_without_a_contraction_are_spanned():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32))
    # the registry's hook on a model built outside it, at a toy width
    model = span_model(VisionTransformer(
        image_size=32, patch_size=8, num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64,
        num_classes=10, ctx=qtt.QuantCtx(W8A8), device="cpu"))
    qtt.init_model(model, x, seed=0, device="cpu")
    qtt.calibrate_model(model, [x], device="cpu")
    qtt.pack_model(model, x, device="cpu")
    with torch.no_grad(), torch.profiler.profile() as prof:
        model(x, mode="packed")
    names = {e.name for e in _qtt_events(prof)}
    assert {"qtt.forward.packed", "qtt.block.encoder_layer_0", "qtt.block.encoder_layer_1",
            "qtt.op.layernorm_quant_int8", "qtt.op.layernorm", "qtt.op.mha_rows"} <= names


def test_qat_step_phases_nest_in_the_step(qat):
    with torch.profiler.profile() as prof:
        _step(qat)
    events = _qtt_events(prof)
    step = [e for e in events if e.name == "qtt.qat.step"]
    assert len(step) == 1
    s = step[0].time_range
    for phase in PHASES:
        (e,) = [e for e in events if e.name == "qtt." + phase]
        assert s.start <= e.time_range.start <= e.time_range.end <= s.end
    assert any(e.name == "qtt.forward.quant" for e in events)
    totals = profiling.span_totals()
    assert all(totals[p][0] == 1 for p in PHASES + ("qat.step",))
    assert sum(totals[p][1] for p in PHASES) <= totals["qat.step"][1]


def test_session_holds_the_last_profiled_stretch_alone(testcnn):
    model, x = testcnn
    with torch.no_grad():
        with torch.profiler.profile():  # the warm-up
            model(x, mode="packed")
        for _ in range(3):  # the unprofiled window
            model(x, mode="packed")
        with torch.profiler.profile():  # the stretch
            for _ in range(2):
                model(x, mode="packed")
        model(x, mode="packed")  # off: the totals stay the stretch's
    totals = profiling.span_totals()
    assert totals["forward.packed"][0] == 2
    assert totals["op.qconv2d"][0] == 4 and totals["op.w8a8_gemm"][0] == 4


def test_totals_from_two_threads_add_up():
    n, barrier = 200, threading.Barrier(2)

    def work():
        barrier.wait(timeout=30)
        for _ in range(n):
            with profiling.span("thread.work"):
                pass

    with torch.profiler.profile():
        with profiling.span("thread.main"):
            pass
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    totals = profiling.span_totals()
    assert totals["thread.work"][0] == 2 * n and totals["thread.main"][0] == 1


def test_trace_writes_the_span_totals(tmp_path, testcnn):
    model, x = testcnn
    with torch.no_grad():
        with profiling.trace(str(tmp_path / "a")):
            model(x, mode="packed")
        # a second trace straight after: its own totals, not the sum
        with profiling.trace(str(tmp_path / "b")):
            model(x, mode="packed")
            model(x, mode="packed")
    a = json.loads((tmp_path / "a" / profiling.SPANS_FILE).read_text())
    b = json.loads((tmp_path / "b" / profiling.SPANS_FILE).read_text())
    assert a["forward.packed"]["count"] == 1 and b["forward.packed"]["count"] == 2
    assert b["op.qconv2d"]["count"] == 4 and b["op.qconv2d"]["host_s"] > 0
    events = json.loads((tmp_path / "b" / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert sum(e.get("name") == "qtt.forward.packed" for e in events) == 2


def test_a_spanned_model_deep_copies_onto_the_copy(testcnn):
    import copy

    model, x = testcnn
    twin = copy.deepcopy(model)
    assert twin.forward.__self__ is twin
    with torch.no_grad():
        want = model(x, mode="packed")  # off: the next profiled span opens a session
        with torch.profiler.profile():
            out = twin(x, mode="packed")
    assert profiling.span_totals()["forward.packed"][0] == 1
    torch.testing.assert_close(out, want, rtol=0, atol=0)
