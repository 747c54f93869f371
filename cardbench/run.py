#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

``<name>`` is a cell of ``BENCHMARK.json`` (a configuration under a
traffic mix), found by name: the configuration's file
``cardbench/configs/<config>.json`` and its family's port adapter and
plain reference (``families/<family>.py``, ``refs/<family>.py``), the
traffic file ``cardbench/traffic/<traffic>.json``, and each per-layer
metric's reader ``cardbench/metrics/<metric>.py``.  A new cell or metric
is new files and entries, never an edit.

One run: make the weights on the card from the seed, build the port's
``ServingEngine``, warm it up on a short request (set-up ends here:
``setup_s``), then serve the traffic for ``--seconds`` on the wall clock
and drain (``pump.py``), and check what the timed path produced against
the plain reference (``check.py``).  With ``--trace 0`` the result holds
the end-to-end metrics, with ``--trace 1`` the per-layer metrics, from a
run with the engine's op profiler on and ``torch.profiler`` over a
sub-window.  The last line of standard output is the result, one JSON
object; the numbers compared are the last lines of standard error.

Exits 2 without a card, 3 without the port beside the benchmark, 4 when
JAX or the JAX package was loaded; none of those prints a result.
"""

import os
import time

T_START = time.perf_counter()
# one process with few threads: the decode tick is bound by the host's
# launches, and idle worker threads of the CPU math libraries spinning
# beside it on a shared host spread its times
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str):
    return load_module(os.path.join(HERE, "families", f"{name}.py"),
                       f"cardbench_family_{name}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its relatives' or
    the JAX package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def pct(values, p: float) -> float:
    """The p-th percentile, linear between order statistics."""
    import numpy as np
    return float(np.percentile(np.asarray(values, float), p))


@dataclass
class Run:
    """What a run observed, for the metric readers."""
    c: dict
    traffic: dict
    stamps: object
    work: object
    end_s: float
    ops: Dict[str, tuple] = field(default_factory=dict)   # name: (n, us)
    trace: Optional[dict] = None
    kernel_least: Optional[Dict[str, float]] = None        # group: s

    def op_ms(self, name: str) -> Optional[float]:
        n, us = self.ops.get(name, (0, 0.0))
        return us / n / 1e3 if n else None


def decide(widest: Optional[float], served: int, lim: dict,
           same: bool = True) -> tuple:
    """``correct`` and the numbers compared, each with its limit: the
    widest gap of the served tokens against the reference, the tokens
    checked, and whether the run left the weights as they were made."""
    checks = [("widest_gap", widest, float(lim["max_gap"])),
              ("served_tokens_checked", served, int(lim["tokens"])),
              ("weights_changed", 0 if same else 1, 0)]
    # no finished request to check reads as None, and is not correct
    correct = (widest is not None and widest <= lim["max_gap"]
               and served >= int(lim["tokens"]) and same)
    return bool(correct), checks


def end_to_end(st, end_s: float) -> tuple:
    """TTFT of every request due in the window (due -> first token; a
    request with no first token by the run's end at its end), and every
    gap between a request's successive tokens, pooled (an unfinished
    request adds the gap from its last token to the run's end)."""
    ttft, gaps, failed = [], [], 0
    for rid, due in st.due.items():
        toks = st.tokens[rid]
        ttft.append((toks[0] if toks else end_s) - due)
        gaps.extend(b - a for a, b in zip(toks, toks[1:]))
        if not st.finished(rid):
            failed += 1
            if toks:
                gaps.append(end_s - toks[-1])
    return ttft, gaps, failed


def kernel_least_s(c: dict, st, t_on: float, t_off: float) -> dict:
    """The summed least time (``yardstick.least_s`` of each call's useful
    flops and bytes) of the port's kernel calls that the chunks and ticks
    which started inside [t_on, t_off) made: K3 a chunk a layer (and K2
    over its history), K1 a tick a layer, K5 a chunk a layer."""
    import yardstick as ys
    out = {}

    def add(g, n, fb):
        out[g] = out.get(g, 0.0) + n * ys.least_s(*fb)

    if c["family"] == "llama":
        H, KVH = c["num_attention_heads"], c["num_key_value_heads"]
        D = c.get("head_dim") or c["hidden_size"] // H
        A = c["num_hidden_layers"]
        for rid, off, L, w0 in st.chunks:
            if t_on <= w0 < t_off:
                add("K3", A, ys.k3_work(1, L, H, D, L, KVH, 2, True))
                if off:
                    add("K2", A, ys.k2_work(1, L, H, D, off, KVH, 2))
        for w0, w1, n, lens in st.ticks:
            if t_on <= w0 < t_off and n:
                add("K1", A, ys.k1_work(lens, H, D, KVH, 2))
    else:
        d_in = c["expand"] * c["d_model"]
        P, G, N = c["headdim"], c["ngroups"], c["d_state"]
        for rid, off, L, w0 in st.chunks:
            if t_on <= w0 < t_off:
                add("K5", c["n_layer"],
                    ys.k5_work(1, L, d_in // P, P, G, N, 2, off > 0))
    return out


END_TO_END = {
    "setup_s": lambda setup, ttft, gaps: setup,
    "ttft_p50_s": lambda setup, ttft, gaps: pct(ttft, 50),
    "ttft_p90_s": lambda setup, ttft, gaps: pct(ttft, 90),
    "tbt_p50_ms": lambda setup, ttft, gaps: pct(gaps, 50) * 1e3,
    "tbt_p95_ms": lambda setup, ttft, gaps: pct(gaps, 95) * 1e3,
}


def run_cell(c: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", per_layer=(),
             end_to_end_metrics=tuple(
                 (n, "s" if n.endswith("_s") else "ms") for n in END_TO_END),
             fault: Optional[Callable] = None, control: bool = False,
             rate: Optional[float] = None, check_outputs: bool = True,
             dtype: Optional[str] = None) -> dict:
    """One run of the configuration ``c`` under ``traffic``.  Returns
    {"result": the result line's object, "check": [(name, value,
    limit)], "control": with ``control``, the same decision made on the
    control's tokens: {"correct", "check"}}.  ``per_layer`` lists (name,
    unit) of the per-layer metrics to read in a traced run,
    ``end_to_end_metrics`` those of an untraced run (``END_TO_END``);
    ``fault`` (``faults.FAULTS``) is planted in the engine before the
    window, and what it returns, if anything, undoes it after;
    ``rate`` overrides the traffic file's (the knee sweep, which also
    skips the check with ``check_outputs=False``); ``dtype`` the type the
    program serves in (default the configuration's on the card, float32
    on the CPU)."""
    import numpy as np
    import torch

    import check
    import pump
    import yardstick
    from traffic import Job, make_jobs

    from repro_torch.models.sharding import make_context

    torch.set_num_threads(1)
    fam = family(c["family"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    dtype = getattr(torch, dtype or (c["torch_dtype"] if on_card
                                     else "float32"))
    cfg = fam.port_config(c, dtype=str(dtype).split(".")[-1])
    ctx = make_context(device)
    weights = fam.make_weights(c, seed, dev, dtype=dtype)
    before = check.fingerprint(weights)
    eng = pump.build_engine(cfg, weights, ctx, traffic["engine"],
                            profile_ops=trace)
    undo = fault(eng) if fault is not None else None
    p = pump.Pump(eng)
    # warm-up: the traffic file's short requests, drained, then forgotten
    rng = np.random.default_rng([seed, 1])
    for i, (n_in, n_out) in enumerate(traffic["warmup"]):
        p.submit(Job(-1 - i, 0.0, rng.integers(
            0, c["vocab_size"], n_in).astype(np.int32), n_out),
            -1 - i, 0.0)
    p.drain()
    p.st = pump.Stamps()
    jobs = make_jobs(traffic, seed, seconds, c["vocab_size"], rate=rate)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops0 = {k: (h.count, h.total) for k, h in eng.metrics.hists.items()}
    dtrace = None
    if trace and on_card:
        import devtrace as tr
        tc = traffic["trace"]
        start = min(float(tc["start_s"]), seconds / 2)
        dtrace = tr.DeviceTrace(start, min(float(tc["seconds"]),
                                           seconds - start), p.now)
        p.on_step = dtrace.on_step
        tr.DeviceTrace.warm()
    # what set-up made lives on: the collector need not scan it again
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    end_s = p.run(jobs, seconds, float(traffic["drain_cap_s"]))
    if dtrace is not None:
        dtrace.stop(p.now())
    if callable(undo):
        undo()
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    st = p.st
    ttft, gaps, failed = end_to_end(st, end_s)
    metrics = {}
    if not trace:
        for name, unit in end_to_end_metrics:
            metrics[name] = {"value": END_TO_END[name](setup_s, ttft, gaps),
                             "unit": unit}
    red = None
    device_extra = {}
    breakdown = None
    if dtrace is not None:
        import devtrace as tr
        spans = st.events + [("sleep", a, b) for a, b in st.sleeps]
        red = dtrace.reduce(spans)
        if red is not None:
            device_extra = {"busy_s": red["busy_s"],
                            "window_s": red["window_s"]}
            breakdown = tr.breakdown(red)
    if trace:
        ops = {k: (h.count - ops0.get(k, (0, 0.0))[0],
                   h.total - ops0.get(k, (0, 0.0))[1])
               for k, h in eng.metrics.hists.items()}
        run = Run(c, traffic, st, yardstick.StepWork(c, fam.layout(c)),
                  end_s, ops=ops, trace=red)
        if red is not None:
            run.kernel_least = kernel_least_s(c, st, dtrace.t_on,
                                             dtrace.t_off)
        for name, unit in per_layer:
            mod = load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                              "cardbench_metric_" + name.replace(".", "_"))
            v = mod.read(run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": unit}
    # ---- correctness: the served tokens of a sample against the reference
    finished = {r: (p.rid_of[r].prompt, list(eng.outputs[r]))
                for r in st.due if st.finished(r) and check_outputs}
    sample = check.pick(finished, seed, int(traffic["check"]["tokens"]))
    items = [finished[r] for r in sample]
    lateness = max((st.submitted[r] - st.due[r] for r in st.due),
                   default=0.0)
    p.eng = None
    del eng, p
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    same = check.fingerprint(weights) == before
    ref = check.load_ref(fam.REF)
    g, cg = check.gaps(ref, weights, c, items, control=control)
    widest = float(max(x.max() for x in g)) if g else None
    served = int(sum(len(s) for _, s in items))
    correct, checks = decide(widest, served, traffic["check"], same)
    out = {"correct": correct, "attempted": len(st.due),
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if on_card
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": peak,
                      **device_extra}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {n: {"value": v, "limit": l} for n, v, l in checks}
    # where a decode tick's time goes: its wall ms (median of the ticks
    # with rows), the share of that wall in which its thread was on a CPU,
    # and in a traced run the mean wall and device-busy ms of a tick in
    # the sub-window (a tick cut by its edges counts by the part inside)
    tick = [(b - a, cpu) for (a, b, n, _), cpu in zip(st.ticks, st.tick_cpu)
            if n]
    tick_host_ms = tick_device_ms = None
    if red is not None:
        inside = [(min(b, dtrace.t_off) - max(a, dtrace.t_on), b - a)
                  for k, a, b in st.events if k == "decode_tick"
                  and b > dtrace.t_on and a < dtrace.t_off and b > a]
        n = sum(x / w for x, w in inside)
        if n > 0:
            in_tick = sum(x for x, _ in inside)
            tick_host_ms = in_tick / n * 1e3
            tick_device_ms = (in_tick - red["idle_s"].get(
                "decode_tick", 0.0)) / n * 1e3
    extra = {"tick_ms_median": pct([w for w, _ in tick], 50) * 1e3
             if tick else None,
             "tick_cpu_share": sum(u for _, u in tick)
             / max(1e-9, sum(w for w, _ in tick)) if tick else None,
             "tick_host_ms": tick_host_ms, "tick_device_ms": tick_device_ms,
             "lateness_s": lateness, "end_s": end_s,
             "trace_cost_s": None if red is None else
             [red["start_cost_s"], red["stop_cost_s"]],
             "requests_checked": len(sample),
             # checked requests whose prompt ran as more than one chunk (a
             # state or KV history handed from chunk to chunk)
             "chunked_requests_checked": sum(
                 1 for r in sample
                 if sum(1 for x in st.chunks if x[0] == r) > 1),
             "event_ms": None if red is None else red["event_ms"],
             "group_s": None if red is None else red["group_s"],
             "group_calls": None if red is None else red["group_calls"]}
    res = {"result": out, "check": checks, "extra": extra,
           "ttft": ttft, "due": [st.due[r] for r in st.due], "gaps": gaps,
           "e2e": [(st.tokens[r][-1] if st.finished(r) else end_s)
                   - st.due[r] for r in st.due]}
    if control:
        # the control in the program's place: the same decision on the
        # tokens the reference in float8 puts first at the same positions
        cw = float(max(x.max() for x in cg)) if cg else None
        c_ok, c_checks = decide(cw, served, traffic["check"])
        res["control"] = {"correct": c_ok, "check": c_checks}
    return res


def cell_files(bench: dict, name: str) -> tuple:
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    c = load_json(ROOT, conf["file"])
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    per_layer = [(m["name"], m["unit"]) for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    e2e = [(m["name"], m["unit"]) for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    return cell, c, traffic, per_layer, e2e


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell, c, traffic, per_layer, e2e = cell_files(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"the port is not beside the benchmark ({src}/repro_torch)",
              file=sys.stderr)
        return 3
    sys.path.insert(0, src)
    res = run_cell(c, traffic, args.seed, args.seconds, bool(args.trace),
                   per_layer=per_layer if args.trace else (),
                   end_to_end_metrics=e2e)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 4
    print(json.dumps({"extra": res["extra"]}), file=sys.stderr)
    for n, v, lim in res["check"]:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
