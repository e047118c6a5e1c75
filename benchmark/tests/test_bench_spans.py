"""The readers of the program's spans (``program_span`` metrics) in traced
rehearsals on the CPU at a toy size (``test_bench_run.py``'s cells): each
reads a positive value in each cell it lists, the kernel wrappers' host time
is part of the forward's, and a training step's phases are parts of it."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark.core import spec
from test_bench_run import CELLS, TRAIN, rehearse

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPANS = {m["name"]: m for m in BENCH["per_layer"] if m["source"] == "program_span"}
PHASES = ("forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train")


def test_every_span_metric_lists_its_cells():
    assert set(SPANS) == {"forward_host_ms.infer", "kernel_host_ms.infer", *PHASES}
    for m in SPANS.values():
        assert m["better"] == "lower" and m["workloads"]
        for cell in m["workloads"]:
            assert m["name"] in {x["name"] for x in spec.load_cell(cell).per_layer}


@pytest.mark.parametrize("name", [CELLS[0], TRAIN[0]])
def test_span_metrics_read_the_stretch(name):
    from quantize_tpu_torch import profiling

    line = rehearse(name, trace=1, seconds=6.0 * 3 if name in TRAIN else 1.5 * 3)
    mine = [m for m, e in SPANS.items() if name in e["workloads"]]
    assert mine and all(line["metrics"][m]["value"] > 0 for m in mine)
    totals = profiling.span_totals()
    if name in TRAIN:
        count, step_s = totals["qat.step"]
        assert count >= 1
        phases = sum(line["metrics"][m]["value"] for m in PHASES)
        readback = 1e3 * totals["qat.readback"][1] / count
        assert phases + readback <= 1e3 * step_s / count
    else:
        metrics = line["metrics"]
        assert metrics["kernel_host_ms.infer"]["value"] <= metrics["forward_host_ms.infer"]["value"]
        assert totals["forward.packed"][0] >= 1
