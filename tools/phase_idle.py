#!/usr/bin/env python3
"""Where a traced benchmark run's time goes by the engine's host phase.

    python3 tools/phase_idle.py --workload yi9b-doc6k --seed 2147483659 \
        [--seconds 50] [--device cuda]

Runs one cell of ``cardbench`` as ``cardbench/run.py --trace 1`` does
(the engine's op profiler on, ``torch.profiler`` over the traffic file's
sub-window) and reads, beside the result line's metrics:

* the eight phase means (``tick.*_ms``, ``chunk.*_ms``) and their sums
  against the pump's wall clock: the tick phases over ``step.tick_ms``,
  the chunk phases over the mean wall of the pump's ``chunk_start``
  events that ran a chunk;
* the card's idle time in the sub-window split by phase: the engine's
  kept phase spans (``OpProfiler.spans``, perf_counter seconds) moved
  onto the pump's clock (perf_counter less the window's open) replace
  the ``decode_tick`` and ``chunk_start`` events they partition, and the
  device trace's reduction (``DeviceTrace.reduce``) splits each idle gap
  over the spans and events it overlaps;
* the caching allocator's retries (each frees cached blocks, which
  waits on the card) and its device mallocs and frees from the window's
  open to its drain's end, beside the chunks run;
* what the instrumentation costs on this host: a handler's phase clock
  (three marks and an end) and an op's pair of CUDA events, enabled and
  disabled, in microseconds.

Prints one JSON line.  On the CPU (``--device cpu``, a rehearsal) there
is no device trace and no CUDA event: those fields are null.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "cardbench"), os.path.join(ROOT, "src")]

import devtrace  # noqa: E402
import pump  # noqa: E402
import run  # noqa: E402

PHASES = ("prep", "launch", "wait", "post")
HANDLER = {"tick": "decode_tick", "chunk": "chunk_start"}
ALLOC = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def alloc_counts() -> dict:
    import torch
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k) for k in ALLOC}


def phase_events(spans, t0: float, events, lo: float, hi: float) -> list:
    """The kept spans on the pump's clock, in place of the handler events
    they partition, and the other events, all cut to those that overlap
    ``[lo, hi)``."""
    mine = sorted((n, a - t0, b - t0) for n, a, b in spans)
    starts = {f: sorted(a for n, a, _ in mine if n.startswith(f + "."))
              for f in HANDLER}
    out = [s for s in mine if s[2] > lo and s[1] < hi]
    for kind, a, b in events:
        if b <= lo or a >= hi:
            continue
        fam = next((f for f, k in HANDLER.items() if k == kind), None)
        if fam is not None:
            s = starts[fam]
            i = bisect.bisect_left(s, a)
            if i < len(s) and s[i] <= b:
                continue                    # its phases stand for it
        out.append((kind, a, b))
    return out


def cost_us(device: str, n: int = 20000) -> dict:
    """Microseconds a handler's phase clock and an op's event pair take,
    enabled and disabled."""
    import torch

    from repro_torch.serving.telemetry import MetricsRegistry, OpProfiler
    out = {}
    for on in (True, False):
        prof = OpProfiler(MetricsRegistry(), enabled=on,
                          device=torch.device(device))
        t = time.perf_counter()
        for _ in range(n):
            ph = prof.phases("tick")
            ph.mark("prep")
            ph.mark("launch")
            ph.mark("wait")
            ph.end("post")
        out["handler_on" if on else "handler_off"] = \
            (time.perf_counter() - t) / n * 1e6
        prof.spans.clear()
        t = time.perf_counter()
        for _ in range(n):
            with prof.op("x"):
                pass
        prof.collect(block=True)
        out["op_on" if on else "op_off"] = (time.perf_counter() - t) / n * 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = run.load_json(ROOT, "BENCHMARK.json")
    _, c, traffic, per_layer, _ = run.cell_files(bench, args.workload)
    seconds = args.seconds or float(bench["run_seconds"])
    seen = {}
    build, pump_run = pump.build_engine, pump.Pump.run
    reduce = devtrace.DeviceTrace.reduce

    def build_engine(*a, **k):
        seen["eng"] = build(*a, **k)
        return seen["eng"]

    def run_window(self, *a, **k):
        seen["pump"] = self
        if args.device == "cuda":
            seen["alloc0"] = alloc_counts()
        return pump_run(self, *a, **k)

    def reduce_by_phase(self, events):
        seen["alloc1"] = alloc_counts()
        red = reduce(self, events)
        evs = phase_events(seen["eng"].profiler.spans, seen["pump"].t0,
                           events, self.t_on, self.t_off)
        seen["by_phase"] = reduce(self, evs)
        return red

    pump.build_engine, pump.Pump.run = build_engine, run_window
    devtrace.DeviceTrace.reduce = reduce_by_phase
    try:
        res = run.run_cell(c, traffic, args.seed, seconds, True,
                           device=args.device, per_layer=per_layer)
    finally:
        pump.build_engine, pump.Pump.run = build, pump_run
        devtrace.DeviceTrace.reduce = reduce
    got = {k: v["value"] for k, v in res["result"]["metrics"].items()}
    st = seen["pump"].st
    ran = {w0 for *_, w0 in st.chunks}
    walls = [b - a for k, a, b in st.events
             if k == "chunk_start" and a in ran]
    sums = {f: sum(got.get(f"{f}.{p}_ms", 0.0) for p in PHASES)
            for f in HANDLER}
    red = seen.get("by_phase")
    card = alloc = None
    if red is not None:
        alloc = {k: seen["alloc1"][k] - seen["alloc0"][k] for k in ALLOC
                 if seen["alloc0"][k] is not None}
        alloc["chunks"] = len(st.chunks)
    if args.device == "cuda":
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    out = {"workload": args.workload, "seed": args.seed, "card": card,
           "correct": res["result"]["correct"], "metrics": got,
           "extra": res["extra"],
           "tick_phases_over_tick_ms": sums["tick"] / got["step.tick_ms"]
           if got.get("step.tick_ms") else None,
           "chunk_phases_over_chunk_wall": sums["chunk"]
           / (sum(walls) / len(walls) * 1e3) if walls else None,
           "chunk_wall_ms": sum(walls) / len(walls) * 1e3 if walls else None,
           "idle_by_event": res["result"].get("breakdown", {}).get(
               "idle_gaps"),
           "idle_by_phase": None if red is None else dict(sorted(
               red["idle_s"].items(), key=lambda kv: -kv[1])),
           "window_s": None if red is None else red["window_s"],
           "busy_s": None if red is None else red["busy_s"],
           "allocator": alloc,
           "cost_us": cost_us(args.device)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
