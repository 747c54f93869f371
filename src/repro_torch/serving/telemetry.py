"""Unified serving telemetry: lifecycle tracer, metrics, attribution.

The engine's latency story used to live in four disconnected ad-hoc lists
(``preempt_log``, ``restripe_log``, ``mixed_log``, ``swap_stats``) plus
per-benchmark one-off aggregation.  This module is the single layer they
all report through:

* **Tracer** — an append-only record of every request's lifecycle on the
  event timeline (arrive, plan, chunk execution, transfer, preempt/
  requeue, swap round trips, restripe, decode ticks fused vs standalone,
  finish).  The recording sites live in ``Simulator``/``ServingEngine``;
  the tracer itself is engine-agnostic.  Spans with known duration
  (chunks, ticks) are recorded directly; paired begin/end spans
  (transfer, swap, decode residency) go through ``begin``/``end`` so
  ``open_spans`` can prove everything closed at finish.  ``to_chrome``
  exports Chrome trace-event JSON (load in Perfetto / chrome://tracing;
  one track per prefill/decode instance plus one per request).

* **MetricsRegistry** — named counters, gauges and log-bucketed
  histograms sampled at event boundaries (TTFT, TBT, queue depth,
  per-shard free blocks / ``effective_free``, swap PCIe bytes, piggyback
  vs deferred ticks, restripe stall ticks).  ``cache_manager``,
  ``transfer``, ``kv_offload`` and ``kv_fabric`` bind into a registry
  via their ``bind_metrics`` hooks.  The cluster KV fabric's canonical
  metric names live in ``FABRIC_METRICS`` (``fabric/swap_in_placed``,
  ``fabric/swap_in_pinned``, ``fabric/leases_active``, ...): counters
  for placed vs pinned swap-in resumes, lease grants/recalls, peer
  prefix promotions and interconnect bytes, plus a ``leases_active``
  gauge sampled on every grant/recall.

* **TTFT/TBT attribution** — ``Tracer.attribution`` decomposes a
  request's TTFT into queueing + chunk compute + transfer +
  preempt-requeue + swap-wait (+ decode-resident, for preempted
  requests) components that sum *bit-exactly* to the observed TTFT, and
  ``Tracer.tbt_causes`` tags every inter-token gap with its cause
  (standalone tick, fused window, swap, preempt, restripe, deferral).

Exactness: all components except ``queue_wait`` are measured by walking
the request's lifecycle events as a state machine over consecutive
``[last_event, this_event]`` intervals (clipped to the TTFT window — no
interval is ever double-counted).  ``queue_wait`` — definitionally the
unattributed remainder — is then chosen so the left-to-right float sum
in ``ATTRIBUTION_ORDER`` reproduces the observed TTFT bit-for-bit
(``exact_remainder``: the naive remainder nudged by ULPs until the
fixed-order sum is exact).  ``attribution_total`` is the canonical
summation every consumer must use.
"""

from __future__ import annotations

import json
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "ATTRIBUTION_ORDER", "Counter", "FABRIC_METRICS", "Gauge",
    "Histogram", "MetricsRegistry", "OpProfiler", "TraceEvent", "Tracer",
    "attribution_total", "build_trace_doc", "exact_remainder",
]

# Canonical metric names published by the cluster KV fabric
# (serving/kv_fabric.py, bound under the "fabric/" prefix).  All are
# counters except ``leases_active``, a gauge sampled at every lease
# grant/recall.  Consumers (dashboards, the rollup-audit tests) should
# reference these instead of re-spelling the strings.
FABRIC_METRICS = (
    "fabric/swap_in_placed",      # swap victims resumed on a non-origin did
    "fabric/swap_in_pinned",      # swap victims resumed where they left
    "fabric/leases_out",          # page leases granted donor -> borrower
    "fabric/leases_recalled",     # leases returned (pressure or release)
    "fabric/lease_blocks_out",    # blocks moved off donors' free lists
    "fabric/lease_blocks_recalled",
    "fabric/peer_promotions",     # prefix chains copied from a peer pool
    "fabric/peer_promoted_blocks",
    "fabric/interconnect_bytes",  # device-to-device bytes, all causes
    "fabric/leases_active",       # gauge: leases currently outstanding
)


# ---------------------------------------------------------------- metrics
class Counter:
    """Monotonic counter (floats allowed: PCIe bytes are fractional)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-value gauge; ``set`` with a timestamp also appends to the
    sample series so the Chrome export can draw a counter track."""

    __slots__ = ("value", "samples")

    def __init__(self) -> None:
        self.value = 0.0
        self.samples: List[Tuple[float, float]] = []

    def set(self, v: float, t: Optional[float] = None) -> None:
        self.value = float(v)
        if t is not None:
            self.samples.append((float(t), float(v)))


class Histogram:
    """Log-bucketed histogram: values land in power-of-``factor`` buckets
    above ``base`` (plus one underflow bucket for ``v <= base``), so a
    fixed small number of buckets spans microseconds to minutes."""

    __slots__ = ("base", "factor", "buckets", "count", "total",
                 "vmin", "vmax")

    def __init__(self, base: float = 1e-6, factor: float = 2.0) -> None:
        self.base = base
        self.factor = factor
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bucket(self, v: float) -> int:
        if v <= self.base:
            return -1
        return int(math.floor(math.log(v / self.base, self.factor))) + 1

    def observe(self, v: float) -> None:
        v = float(v)
        self.buckets[self._bucket(v)] = self.buckets.get(
            self._bucket(v), 0) + 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, p: float) -> float:
        """Bucket-resolution percentile: the upper bound of the bucket
        holding the p-th sample (exact at the recorded min/max ends)."""
        if not self.count:
            return math.nan
        target = max(1, math.ceil(self.count * p / 100.0))
        seen = 0
        for b in sorted(self.buckets):
            seen += self.buckets[b]
            if seen >= target:
                hi = self.base * self.factor ** b if b >= 0 else self.base
                return float(min(max(hi, self.vmin), self.vmax))
        return self.vmax

    def snapshot(self) -> dict:
        return {"count": self.count, "mean": self.mean(),
                "min": self.vmin if self.count else math.nan,
                "max": self.vmax if self.count else math.nan,
                "p50": self.percentile(50), "p99": self.percentile(99),
                "buckets": {str(k): v
                            for k, v in sorted(self.buckets.items())}}


class MetricsRegistry:
    """Create-on-demand registry of named counters/gauges/histograms."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def hist(self, name: str) -> Histogram:
        return self.hists.setdefault(name, Histogram())

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self.hists.items())},
        }


class OpProfiler:
    """Optional timing hooks around the engine's device work.  Disabled it
    is a no-op context manager.  Enabled on a CUDA device it records a
    pair of CUDA events around the op and feeds the device time into
    ``op_device_us/<name>`` (the host thread waits for the end event, so
    profiling serialises the host with the card); elsewhere it feeds host
    wall clock into ``op_wall_us/<name>``."""

    def __init__(self, metrics: MetricsRegistry, enabled: bool = False,
                 device=None):
        self.metrics = metrics
        self.enabled = enabled
        self.device = device

    @contextmanager
    def op(self, name: str):
        if not self.enabled:
            yield
            return
        if self.device is not None and self.device.type == "cuda":
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                self.metrics.hist(f"op_device_us/{name}").observe(
                    start.elapsed_time(end) * 1e3)
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.metrics.hist(f"op_wall_us/{name}").observe(
                (time.perf_counter() - t0) * 1e6)


# ----------------------------------------------------------- attribution
# Canonical summation order for TTFT attribution.  ``queue_wait`` is the
# exact remainder and MUST come last; every consumer sums left-to-right
# in this order (attribution_total) so the bit-equality guarantee holds.
ATTRIBUTION_ORDER = ("chunk_compute", "transfer", "preempt_requeue",
                     "swap_wait", "decode_resident", "queue_wait")


def attribution_total(comps: Dict[str, float]) -> float:
    """The canonical left-to-right float sum of attribution components.
    With ``comps`` from ``Tracer.attribution`` this equals the observed
    TTFT bit-for-bit."""
    s = 0.0
    for k in ATTRIBUTION_ORDER:
        s += comps.get(k, 0.0)
    return s


def exact_remainder(target: float, measured: Iterable[float]) -> float:
    """The value ``q`` such that summing ``[*measured, q]`` left-to-right
    in float arithmetic yields exactly ``target``.

    Starts from the naive remainder and walks it by ULPs toward the
    correction (a short fixpoint: float addition is monotonic in each
    argument, so the walk terminates in a few steps)."""
    s = 0.0
    for v in measured:
        s += v
    q = target - s
    for _ in range(64):
        got = s + q
        if got == target:
            return q
        q = math.nextafter(q, math.inf if got < target else -math.inf)
    # pathological cancellation (never seen on event-clock floats): fall
    # back to the naive remainder — callers detect via attribution_total
    return target - s


# ---------------------------------------------------------------- tracer
@dataclass
class TraceEvent:
    """One timeline record.  ``t`` is the event-clock time (span start
    for events with ``dur > 0``), ``track`` names the Perfetto track
    (e.g. ``("decode", 0)``, ``("request", 3)``), ``rid`` the request it
    belongs to (None for engine-wide events), ``args`` free-form
    payload."""
    seq: int
    t: float
    kind: str
    track: Tuple[str, int]
    rid: Optional[int] = None
    dur: float = 0.0
    args: dict = field(default_factory=dict)


# request-lifecycle instants the attribution state machine consumes; all
# other kinds (derived spans, ticks, engine-wide events) are ignored by it
_LIFECYCLE = {"arrive", "plan", "reject", "chunk", "requeue",
              "transfer_begin", "admit", "preempt", "swap_out",
              "swap_in_done", "finish"}


class Tracer:
    """Append-only lifecycle tracer (see module docstring).

    ``enabled=False`` turns every recording call into a cheap no-op —
    the pure Simulator runs with tracing off by default so large stress
    sweeps pay nothing; the real engine always traces."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 enabled: bool = True):
        self.enabled = enabled
        self.metrics = metrics or MetricsRegistry()
        self.events: List[TraceEvent] = []
        self._by_rid: Dict[int, List[TraceEvent]] = {}
        self._open: Dict[Tuple[str, int], Tuple[float, Tuple[str, int],
                                                dict]] = {}

    # ------------------------------------------------------------ record
    def record(self, t: float, kind: str,
               track: Tuple[str, int] = ("engine", 0),
               rid: Optional[int] = None, dur: float = 0.0,
               **args: Any) -> Optional[TraceEvent]:
        if not self.enabled:
            return None
        ev = TraceEvent(len(self.events), float(t), kind, track, rid,
                        float(dur), args)
        self.events.append(ev)
        if rid is not None:
            self._by_rid.setdefault(rid, []).append(ev)
        return ev

    def begin(self, name: str, rid: int, t: float,
              track: Tuple[str, int] = ("engine", 0), **args: Any) -> None:
        """Open a paired span; ``end`` emits it as one complete event.
        Re-opening an already-open (name, rid) span restarts it."""
        if self.enabled:
            self._open[(name, rid)] = (float(t), track, args)

    def end(self, name: str, rid: int, t: float,
            **args: Any) -> Optional[TraceEvent]:
        if not self.enabled:
            return None
        opened = self._open.pop((name, rid), None)
        if opened is None:
            return None
        t0, track, a0 = opened
        return self.record(t0, name, track=track, rid=rid,
                           dur=max(0.0, float(t) - t0), **{**a0, **args})

    def end_all(self, rid: int, t: float) -> None:
        """Close every span still open for ``rid`` (at finish)."""
        for name, r in [k for k in self._open if k[1] == rid]:
            self.end(name, r, t)

    def open_spans(self) -> Dict[Tuple[str, int], float]:
        """(name, rid) -> start time of spans not yet closed.  Empty
        after a drained serve() — the span well-formedness invariant."""
        return {k: v[0] for k, v in self._open.items()}

    # ------------------------------------------------------------- views
    def entries(self, kind: str) -> List[dict]:
        """Payload dicts of all ``kind`` events in record order — the
        back-compat backing of ``preempt_log``/``restripe_log``/
        ``mixed_log`` (each event carries the legacy dict verbatim under
        ``args["entry"]``)."""
        return [e.args["entry"] for e in self.events if e.kind == kind]

    def events_for(self, rid: int) -> List[TraceEvent]:
        return list(self._by_rid.get(rid, []))

    def _lifecycle(self, rid: int) -> List[TraceEvent]:
        evs = [e for e in self._by_rid.get(rid, [])
               if e.kind in _LIFECYCLE]
        evs.sort(key=lambda e: (e.t, e.seq))
        return evs

    # ------------------------------------------------- TTFT attribution
    def attribution(self, rid: int, arrival: float,
                    prefill_done: float) -> Dict[str, float]:
        """Decompose ``prefill_done - arrival`` (the observed TTFT) into
        the ``ATTRIBUTION_ORDER`` components.

        Walks the request's lifecycle instants in time order as a state
        machine: each consecutive ``[prev_event, this_event]`` interval
        (clipped to the TTFT window) accrues to the state the request
        was in — so intervals partition the covered span and can never
        double-count.  ``queue_wait`` is the exact remainder (see
        ``exact_remainder``); ``attribution_total`` of the result equals
        the observed TTFT bit-for-bit."""
        win0, win1 = float(arrival), float(prefill_done)
        comps = {k: 0.0 for k in ATTRIBUTION_ORDER}

        def accrue(cat: str, a: float, b: float) -> None:
            lo, hi = max(a, win0), min(b, win1)
            if hi > lo:
                comps[cat] += hi - lo

        state = "queue_wait"
        last = win0
        pending_end: Optional[float] = None     # open chunk span's end
        for ev in self._lifecycle(rid):
            te = ev.t
            if pending_end is not None:
                if pending_end <= te:
                    accrue("chunk_compute", last, pending_end)
                    accrue("queue_wait", pending_end, te)
                else:           # next event lands inside the chunk span
                    accrue("chunk_compute", last, te)
                pending_end = None
            else:
                accrue(state, last, te)
            last = te
            k = ev.kind
            if k == "chunk":
                pending_end = te + ev.dur
                state = "queue_wait"            # resumes after the span
            elif k in ("plan", "arrive"):
                state = "queue_wait"
            elif k == "requeue":
                state = "preempt_requeue"
            elif k == "preempt":
                state = ("swap_wait"
                         if ev.args.get("entry", {}).get("policy") == "swap"
                         else "preempt_requeue")
            elif k == "transfer_begin":
                state = "transfer"
            elif k == "admit":
                state = "decode_resident"
            elif k == "swap_out":
                state = "swap_wait"
            elif k == "swap_in_done":
                state = "decode_resident"
        if pending_end is not None:
            accrue("chunk_compute", last, pending_end)
            last = pending_end
        elif state != "queue_wait":
            # trailing interval: the request stayed in its final state
            # until the window closed (the remainder is queue_wait)
            accrue(state, last, win1)
        measured = [comps[k] for k in ATTRIBUTION_ORDER
                    if k != "queue_wait"]
        comps["queue_wait"] = exact_remainder(win1 - win0, measured)
        return comps

    # --------------------------------------------------- TBT attribution
    def tbt_causes(self, rid: int) -> List[str]:
        """One cause tag per inter-token gap of ``rid`` (length =
        len(token_times) - 1), in emission order.  Priority when several
        apply to a gap: swap > preempt > restripe > deferral > the
        emitting tick's own mode (fused / standalone)."""
        emits: List[Tuple[float, str, Tuple[str, int]]] = []
        for e in self.events:
            if e.kind == "tick" and rid in e.args.get("rids", ()):
                emits.append((e.t + e.dur, e.args.get("mode", "standalone"),
                              e.track))
        emits.sort(key=lambda x: x[0])
        swaps = [(e.t, e.t + e.dur) for e in self._by_rid.get(rid, [])
                 if e.kind == "swap"]
        preempts = [e.t for e in self._by_rid.get(rid, [])
                    if e.kind == "preempt"
                    and e.args.get("entry", {}).get("policy") != "swap"]
        restripes = [e.t for e in self.events if e.kind == "restripe"]
        defers = [(e.t, e.track) for e in self.events if e.kind == "defer"]
        out = []
        for (t0, _, _), (t1, mode, track) in zip(emits, emits[1:]):
            if any(a < t1 and b > t0 for a, b in swaps):
                out.append("swap")
            elif any(t0 < t <= t1 for t in preempts):
                out.append("preempt")
            elif any(t0 < t <= t1 for t in restripes):
                out.append("restripe")
            elif any(t0 < t <= t1 and tr == track for t, tr in defers):
                out.append("deferral")
            else:
                out.append("fused" if mode == "fused" else "standalone")
        return out

    def tick_token_counts(self) -> Dict[str, int]:
        """Batch tokens emitted by recorded decode ticks, by mode — the
        tracer-side half of the tick conservation law (must equal the
        per-instance piggyback/standalone gauges and Σ output_len)."""
        out = {"fused": 0, "standalone": 0}
        for e in self.events:
            if e.kind == "tick":
                out[e.args.get("mode", "standalone")] += len(
                    e.args.get("rids", ()))
        return out

    # ------------------------------------------------------ chrome export
    def to_chrome(self) -> List[dict]:
        """Chrome trace-event JSON array (``traceEvents``): every tracer
        event becomes exactly one ``ph="X"`` (dur > 0) or ``ph="i"``
        (instant) event — event counts are preserved — plus ``M``
        metadata naming the process/thread tracks and ``C`` counter
        samples from time-stamped gauges.  Times are µs as Perfetto
        expects."""
        pids = {"requests": 1, "prefill": 2, "decode": 3, "engine": 4}
        named: set = set()
        meta: List[dict] = []
        out: List[dict] = []

        def name_track(track: Tuple[str, int]) -> Tuple[int, int]:
            kind, idx = track
            pid = pids.setdefault(kind if kind != "request" else "requests",
                                  len(pids) + 1)
            if ("p", pid) not in named:
                named.add(("p", pid))
                pname = "requests" if kind == "request" else kind
                meta.append({"ph": "M", "name": "process_name", "pid": pid,
                             "tid": 0, "args": {"name": pname}})
            if (pid, idx) not in named:
                named.add((pid, idx))
                tname = (f"req {idx}" if kind == "request"
                         else f"{kind} {idx}")
                meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": idx, "args": {"name": tname}})
            return pid, idx

        for e in self.events:
            pid, tid = name_track(e.track)
            args = {k: _jsonable(v) for k, v in e.args.items()}
            if e.rid is not None:
                args.setdefault("rid", e.rid)
            rec = {"name": e.kind, "cat": "serving", "pid": pid, "tid": tid,
                   "ts": e.t * 1e6, "args": args}
            if e.dur > 0.0:
                rec["ph"] = "X"
                rec["dur"] = e.dur * 1e6
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            out.append(rec)
        for name, g in sorted(self.metrics.gauges.items()):
            for t, v in g.samples:
                out.append({"name": name, "cat": "metrics", "ph": "C",
                            "pid": pids["engine"], "tid": 0, "ts": t * 1e6,
                            "args": {"value": v}})
        return meta + out


def _jsonable(v: Any) -> Any:
    """Coerce event payloads (numpy scalars, tuples) to JSON-clean."""
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if hasattr(v, "item"):
        return v.item()
    return str(v)


# ---------------------------------------------------------- trace export
def build_trace_doc(tracer: Tracer, reqs: Dict[int, Any],
                    metrics: Optional[MetricsRegistry] = None) -> dict:
    """Assemble the exported trace document: the Chrome ``traceEvents``
    array (Perfetto loads the file directly; the extra top-level keys are
    ignored by the viewer) plus a structured per-request record with the
    TTFT attribution and TBT causes, and the metrics snapshot."""
    metrics = metrics or tracer.metrics
    requests = {}
    for rid, r in sorted(reqs.items()):
        rec = {"arrival": r.arrival, "prompt_len": r.prompt_len,
               "output_len": r.output_len, "prefill_done": r.prefill_done,
               "transfer_done": r.transfer_done,
               "first_token": r.first_token, "done": r.done,
               "ttft": r.ttft, "token_times": list(r.token_times),
               "preemptions": r.preemptions,
               "events": [{"t": e.t, "kind": e.kind, "dur": e.dur,
                           "args": _jsonable(e.args)}
                          for e in tracer.events_for(rid)]}
        if r.prefill_done is not None:
            rec["attribution"] = tracer.attribution(rid, r.arrival,
                                                    r.prefill_done)
            rec["tbt_causes"] = tracer.tbt_causes(rid)
        requests[str(rid)] = rec
    return {"schema": "trace/v1",
            "traceEvents": tracer.to_chrome(),
            "requests": requests,
            "metrics": metrics.snapshot()}


def write_trace(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f)
