#!/usr/bin/env python3
"""The knee sweep: offer a cell's traffic at a few fixed rates and find the
highest rate the engine sustains, the one at which the queue does not
grow through the window.

    python3 cardbench/knee.py --workload yi9b-doc6k --rates 1.6,2,2.4 \
        --seeds 7,8 --seconds 50

One process; each rate on each seed is a run of ``run.run_cell`` without
the output check.  One JSON line a run: the end-to-end numbers, the
backlog (requests due and not yet finished, on the wall clock) averaged
over the window's second and fourth quarters, and the slopes of TTFT and
of the whole latency (due to last token) against due time (least
squares, seconds a second).  A run is sustained where every request
finished and the backlog's fourth-quarter mean is at most
``GROWTH`` times its second-quarter mean: a queue that keeps up holds
the same backlog all through the window, one that does not grows it
with the time (from the same start, about 2.3 times by then).  The
knee is the highest swept rate below which every run, on every seed,
was sustained; with ``--write`` the cell's traffic file gets 0.8 x the
knee as its rate, and these readings beside it.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import run  # noqa: E402

GROWTH = 1.5


def backlog(due, done, a: float, b: float, step: float = 0.1) -> float:
    """The mean number of requests due and not finished over [a, b)."""
    due, done = np.asarray(due)[:, None], np.asarray(done)[:, None]
    t = np.arange(a, b, step)[None, :]
    return float(((due <= t) & (t < done)).sum(axis=0).mean())


def slope(due, lat) -> float:
    return float(np.polyfit(due, lat, 1)[0]) if len(due) > 1 else 0.0


def reading(res: dict, seconds: float) -> dict:
    due = np.asarray(res["due"])
    done = due + np.asarray(res["e2e"])
    q2 = backlog(due, done, seconds / 4, seconds / 2)
    q4 = backlog(due, done, 3 * seconds / 4, seconds)
    growth = q4 / max(q2, 1e-9)
    return {"backlog_q2": q2, "backlog_q4": q4, "growth": growth,
            "ttft_slope": slope(due, res["ttft"]),
            "e2e_slope": slope(due, res["e2e"]),
            "sustained": res["result"]["failed"] == 0 and growth <= GROWTH}


KEPT = ("rate_per_s", "seed", "attempted", "failed", "ttft_p50_s",
        "ttft_p90_s", "tbt_p50_ms", "tbt_p95_ms", "backlog_q2",
        "backlog_q4", "growth", "ttft_slope", "e2e_slope", "end_s",
        "sustained")


def knee_of(rows: list):
    """The highest swept rate below which every run, on every seed, was
    sustained (None where the lowest failed)."""
    knee = None
    for r in sorted({x["rate_per_s"] for x in rows}):
        if not all(x["sustained"] for x in rows if x["rate_per_s"] == r):
            break
        knee = r
    return knee


def write_traffic(path: str, traffic: dict, rows: list, knee: float,
                  seconds: float, device: str = "") -> None:
    """The traffic file with its rate set to 0.8 x the knee and the
    sweep's readings beside it, one line a run."""
    t = dict(traffic, rate_per_s=round(0.8 * knee, 2))
    t["knee"] = {"rule": (
        f"0.8 x the knee {knee} req/s: the highest swept rate below which "
        f"every run on every seed finished every request and held its "
        f"backlog (the fourth quarter's mean at most {GROWTH} x the "
        f"second's; {seconds:g}-s windows, one process{device})")}
    sig = lambda v: float(f"{v:.4g}") if isinstance(v, float) else v
    sweep = [json.dumps({k: sig(x[k]) for k in KEPT}) for x in rows]
    def field(k, v):
        if isinstance(v, dict) and len(json.dumps(v)) > 72:
            return (f'  "{k}": {{\n' + ",\n".join(
                f"    {json.dumps(a)}: {json.dumps(b)}"
                for a, b in v.items()) + "\n  }")
        return f'  "{k}": {json.dumps(v)}'
    lines = [field(k, v) for k, v in t.items() if k != "knee"]
    lines.append('  "knee": {\n    "rule": ' + json.dumps(t["knee"]["rule"])
                 + ',\n    "sweep": [\n      '
                 + ',\n      '.join(sweep) + '\n    ]\n  }')
    with open(path, "w") as f:
        f.write("{\n" + ",\n".join(lines) + "\n}\n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", default="7")
    ap.add_argument("--seconds", type=float, default=50)
    ap.add_argument("--write", action="store_true",
                    help="set the traffic file's rate to 0.8 x the knee "
                    "and record the sweep in it")
    args = ap.parse_args()
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    cell, c, traffic, _, _ = run.cell_files(bench, args.workload)
    rows = []
    for r in [float(x) for x in args.rates.split(",")]:
        for s in [int(x) for x in args.seeds.split(",")]:
            res = run.run_cell(c, traffic, s, args.seconds, False, rate=r,
                               check_outputs=False)
            m = {k: v["value"] for k, v in res["result"]["metrics"].items()
                 if k != "setup_s"}
            x = res["extra"]
            rows.append({
                "workload": args.workload, "rate_per_s": r, "seed": s,
                "attempted": res["result"]["attempted"],
                "failed": res["result"]["failed"], **m,
                **reading(res, args.seconds), "end_s": x["end_s"],
                "tick_ms_median": x["tick_ms_median"],
                "tick_cpu_share": x["tick_cpu_share"]})
            print(json.dumps(rows[-1]), flush=True)
    knee = knee_of(rows)
    print(json.dumps({"workload": args.workload, "knee_per_s": knee,
                      "rate_per_s": None if knee is None else
                      round(0.8 * knee, 2)}), flush=True)
    if args.write and knee is not None:
        write_traffic(os.path.join(HERE, "traffic",
                                   f"{cell['traffic']}.json"),
                      traffic, rows, knee, args.seconds,
                      ", " + torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
