#!/usr/bin/env python3
"""Find the highest rate a serving cell sustains, each rate in a fresh
process that runs the cell as ``run.py`` does, with only the offered rate
changed.

    python3 benchmark/sweep.py --workload <serving cell> \
        --seeds 7 8 --seconds 10 --forward-ms 18.1 --rates 500 1000 2000 3000

For each rate and seed, one process: ``run.main`` with the cell's own
traffic, engine settings, set-up and window, the rate replaced by the one
swept. The lowest rate swept stands for the unloaded service: its 95th percentile
(the median over the seeds) plus ``--forwards`` forwards (``--forward-ms``
each, the model's forward at the engine's batch) is the ceiling. A rate is
sustained where, on every seed, 99% or more of its requests are done (none
missing at the end of the grace period), its 95th percentile is under the
ceiling, and so is the median latency of the window's last tenth of
requests (a backlog that grows over the window shows there). The highest
rate sustained is the highest below which every rate swept was sustained
too; a cell's rate is set at four fifths of it. Prints one line a run and a
JSON line of the rows and the verdict; ``--rows`` judges the rows of such a
line again, without running anything.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def one(workload: str, seed: int, seconds: float, rate: float) -> int:
    """One run of the cell at ``rate``, in this process."""
    from benchmark import run
    from benchmark.core import spec

    cell = spec.load_cell(workload)
    cell.traffic = {**cell.traffic, "rate_img_per_s": rate}
    return run.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", "0"], cell=cell)


def measure(workload: str, seed: int, seconds: float, rate: float) -> dict:
    proc = subprocess.run([sys.executable, __file__, "--workload", workload, "--one", str(rate),
                           "--seeds", str(seed), "--seconds", str(seconds)],
                          cwd=ROOT, capture_output=True, text=True)
    info = [ln for ln in proc.stderr.splitlines() if ln.startswith("info ")]
    if proc.returncode != 0 or not info:
        return {"rate": rate, "seed": seed, "rc": proc.returncode, "err": proc.stderr[-1500:]}
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    info = json.loads(info[-1][len("info "):])
    return {"rate": rate, "seed": seed, "rc": 0, "correct": line["correct"],
            "done_share": 1 - line["failed"] / line["attempted"],
            "p95_ms": line["metrics"]["latency_p95_ms"]["value"],
            "setup_s": line["metrics"]["setup_s"]["value"], **info}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+")
    ap.add_argument("--forward-ms", type=float, default=18.1)
    ap.add_argument("--forwards", type=float, default=3.0)
    ap.add_argument("--rows", help="a file holding a JSON line of this script")
    ap.add_argument("--one", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        return one(args.workload, args.seeds[0], args.seconds, args.one)

    if args.rows:
        rows = json.loads(Path(args.rows).read_text().strip().splitlines()[-1])["rows"]
    else:
        rows = []
        for rate in sorted(args.rates):
            for seed in args.seeds:
                row = measure(args.workload, seed, args.seconds, rate)
                rows.append(row)
                print(" ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                               for k, v in row.items() if k != "err"), flush=True)
                if row["rc"] != 0:
                    print(row["err"], file=sys.stderr)
    print(json.dumps({**judge(rows, args.forward_ms, args.forwards), "rows": rows}))
    return 0


def judge(rows: list, forward_ms: float, forwards: float) -> dict:
    ok = [r for r in rows if r["rc"] == 0]
    lowest = min(r["rate"] for r in ok)
    unloaded = statistics.median(r["p95_ms"] for r in ok if r["rate"] == lowest)
    ceiling = unloaded + forwards * forward_ms
    sustained = {}
    for r in rows:
        good = (r["rc"] == 0 and r["done_share"] >= 0.99 and r["p95_ms"] <= ceiling
                and r["last_tenth_p50_ms"] <= ceiling)
        sustained[r["rate"]] = sustained.get(r["rate"], True) and good
    best = None
    for rate in sorted(sustained):
        if not sustained[rate]:
            break
        best = rate
    return {"unloaded_p95_ms": unloaded, "p95_ceiling_ms": ceiling, "sustained": sustained,
            "highest_sustained": best,
            "rate_at_four_fifths": None if best is None else 0.8 * best}


if __name__ == "__main__":
    sys.exit(main())
