#!/usr/bin/env python3
"""The readings that set a cell's limit, and the control and the planted
faults through ``correct``: on each seed, a short window at the cell's
own load, then the widest gap of the program's served tokens and the
harness's decision on them, and the same decision on the control's
tokens (the plain reference in float8, put in the program's place, at
the same positions); then, on the first seed, a run with each fault of
``--faults`` (``faults.FAULTS``) planted underneath the timed path.

    python3 cardbench/control.py --workload yi9b-doc6k \
        --seeds 11,12,13 --seconds 20 --faults state_unchanged

One process, one JSON line a run.  The benchmark's own runs do not run
the control.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import run  # noqa: E402
from faults import FAULTS  # noqa: E402


def checked(res: dict) -> dict:
    return {n: v for n, v, _ in res["check"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--faults", default="")
    args = ap.parse_args()
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, c, traffic, _, _ = run.cell_files(bench, args.workload)
    seeds = [int(x) for x in args.seeds.split(",")]
    for s in seeds:
        res = run.run_cell(c, traffic, s, args.seconds, False, control=True)
        chk = checked(res)
        ctl = {n: v for n, v, _ in res["control"]["check"]}
        print(json.dumps({"workload": args.workload, "seed": s,
                          "program_correct": res["result"]["correct"],
                          "program_widest_gap": chk["widest_gap"],
                          "control_correct": res["control"]["correct"],
                          "control_widest_gap": ctl["widest_gap"],
                          "served_tokens_checked":
                              chk["served_tokens_checked"],
                          "requests_checked":
                              res["extra"]["requests_checked"],
                          "attempted": res["result"]["attempted"],
                          "failed": res["result"]["failed"]}), flush=True)
    for name in [f for f in args.faults.split(",") if f]:
        line = {"workload": args.workload, "seed": seeds[0], "fault": name}
        try:
            res = run.run_cell(c, traffic, seeds[0], args.seconds, False,
                               fault=FAULTS[name])
        except Exception as e:       # a run that crashes is not correct
            line.update(correct=False, crashed=repr(e)[:300])
        else:
            chk = checked(res)
            line.update(correct=res["result"]["correct"],
                        widest_gap=chk["widest_gap"],
                        served_tokens_checked=chk["served_tokens_checked"],
                        attempted=res["result"]["attempted"],
                        failed=res["result"]["failed"])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
