"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) is found by its name; its configuration
by the ``file`` that ``configs`` gives it; its traffic mix in
``benchmark/traffic/<traffic>.json``; the cell's own parameters (a rate, the
limits of its comparison) in ``benchmark/workloads/<cell>.json``; a
per-layer metric's reader in ``benchmark/metrics/<name>.py``; a model
family's code in ``benchmark/families/<family>.py``. Adding any of
them needs no edit to a file that is there.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict       # the configuration's file
    traffic: dict      # the traffic mix's file, its parameters under the cell's
    params: dict       # the cell's file
    end_to_end: list   # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    params = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    traffic = {**traffic, **params.get("traffic", {})}
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                params=params,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def family_module(name: str):
    """A model family's code: ``benchmark/families/<name>.py``, which gives
    ``weight_specs``, ``layers``, ``build_kwargs``, ``Reference`` and
    ``TrainReference`` (None where the family has no training reference)."""
    return importlib.import_module(f"benchmark.families.{name}")


def family(config: dict):
    """The family of a configuration (its ``family`` key)."""
    return family_module(config["family"])


def sub_seed(seed: int, stream: str) -> int:
    """A seed of its own for one use (``weights``, ``calibration``, ...) of the
    run's ``seed``: the same pair gives the same number."""
    h = 1469598103934665603
    for ch in f"{int(seed)}/{stream}".encode():
        h = ((h ^ ch) * 1099511628211) % 2 ** 64
    return h % 2 ** 62
