"""BENCHMARK.json and the files it names hold to the benchmark's contract."""
from __future__ import annotations

import ast
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["source"].startswith("https://")
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_entry_and_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] in (1, 4)
    params = json.loads((ROOT / "benchmark" / "workloads" / f"{cell['name']}.json").read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "drivers" / f"{traffic['kind']}.py").is_file()
    limits = params["limits"]
    # an exact comparison (a count that has to be nought) has the limit 0
    assert limits and all(0 <= v < math.inf for v in limits.values())
    # the configuration's family gives the code the traffic kind needs
    from benchmark.core import spec

    entry = {c["name"]: c for c in BENCH["configs"]}[cell["config"]]
    family = spec.family(json.loads((ROOT / entry["file"]).read_text()))
    for name in ("weight_specs", "layers", "build_kwargs", "Reference"):
        assert callable(getattr(family, name)), name
    if traffic["kind"] == "qat_steps":
        assert callable(family.TrainReference)


def test_names_are_unique_and_cells_pair_once():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    e2e = metric in BENCH["end_to_end"]
    keys |= {"bound"} if e2e else {"layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    def reported(cell, group):
        return [m["name"] for m in group if cell in m.get("workloads", CELLS)]

    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for cell in CELLS:
        e2e = reported(cell, BENCH["end_to_end"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reported(cell, BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_what_its_cells_report(metric):
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in moves.get("workloads", CELLS)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    path = ROOT / "benchmark" / "metrics" / f"{metric['name']}.py"
    tree = ast.parse(path.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, f"PERF.md's list of layers lacks {layer!r}"


def test_file_names_under_the_paths():
    ok = re.compile(r"^[A-Za-z0-9_.-]+$")
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            assert all(ok.match(part) for part in f.relative_to(ROOT).parts), f
