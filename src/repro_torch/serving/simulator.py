"""Discrete-event simulator of the disaggregated serving cluster.

Reproduces the paper's evaluation harness (Sec. 6 describes the same
simulator methodology used for the improvement-rate profiler; Sec. 7 stress
tests are latency-model driven): Poisson arrivals, a prefill SP pool with
per-instance queues, pluggable prefill scheduling policies (Tetris CDSP /
single-chunk / LoongServe-greedy / fixed-SP), KV transfer with limited
backends + handshake FIFO ordering, and decode instances with continuous
batching and Llumnix-style "virtual usage" routing.

Policies:
  * ``tetris``          — Algorithm 1 (CDSP) with load-aware improvement rate
  * ``single_chunk``    — Algorithm 2 only (Fig. 13 ablation)
  * ``loongserve``      — greedy max-SP per request (rate=0), non-disagg:
                          decode occupies the SP group (static batching)
  * ``loongserve_disagg``— greedy single-chunk prefill + disagg decode
  * ``fixed_sp_N``      — static SP-N groups, shortest-queue routing
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.chunk_planner import Allocation, CDSPScheduler, Chunk
from repro_torch.core.latency_model import DecodeLatencyModel, PrefillLatencyModel
from repro_torch.serving import telemetry
from repro_torch.serving.request import Phase, Request


@dataclass
class ClusterSpec:
    n_prefill: int = 32
    tp_prefill: int = 1
    n_decode: int = 4
    tp_decode: int = 8
    node_size: int = 8
    cache_slots: int = 4_000_000         # tokens per decode instance
    transfer_bw: float = 40e9            # bytes/s per backend
    kv_bytes_per_token: float = 131_072  # llama3-8b
    backends_per_decode: int = 8
    disaggregated: bool = True
    sp_candidates: Tuple[int, ...] = (1, 2, 4, 8, 16)


# ---------------------------------------------------------------- policies
class Policy:
    name = "base"

    def __init__(self, model: PrefillLatencyModel, spec: ClusterSpec,
                 rate_fn: Optional[Callable[[float], float]] = None):
        self.model = model
        self.spec = spec
        self.rate_fn = rate_fn or (lambda now: 0.3)
        self.sched = CDSPScheduler(
            model, sp_candidates=[s for s in spec.sp_candidates
                                  if s <= spec.n_prefill],
            node_size=spec.node_size)

    def plan(self, req: Request, pool: Dict[int, float], now: float
             ) -> Optional[Allocation]:
        raise NotImplementedError

    def on_arrival(self, now: float) -> None:
        """Called once per request ARRIVAL (not per plan attempt — requeue
        re-plans must not pollute arrival-rate estimates)."""


class TetrisPolicy(Policy):
    name = "tetris"

    def plan(self, req, pool, now):
        return self.sched.schedule(req.prompt_len, pool,
                                   improvement_rate=self.rate_fn(now),
                                   cached_tokens=req.cached_tokens)


class DynamicTetrisPolicy(Policy):
    """Tetris with the paper's online improvement-rate controller: a
    sliding-window arrival-rate estimate indexes the offline-profiled
    optimal-rate table (Sec. 5.1 / Sec. 6)."""
    name = "tetris_dynamic"

    def __init__(self, model, spec, controller):
        super().__init__(model, spec)
        self.controller = controller

    def on_arrival(self, now):
        self.controller.observe(now)

    def plan(self, req, pool, now):
        return self.sched.schedule(req.prompt_len, pool,
                                   improvement_rate=self.controller.rate(now),
                                   cached_tokens=req.cached_tokens)


class SingleChunkPolicy(Policy):
    """Algorithm 2 only — skips lines 5-21 of Algorithm 1 (Fig. 13)."""
    name = "single_chunk"

    def plan(self, req, pool, now):
        group = self.sched.single_chunk_schedule(
            req.prompt_len, Allocation(), self.sched.sp_candidates, pool,
            improvement_rate=self.rate_fn(now))
        if group is None:
            return None
        t_q = max((pool[i] for i in group), default=0.0)
        t_p = self.model.latency(len(group), 0, req.prompt_len)
        return Allocation([Chunk(req.prompt_len, group, t_q, t_q + t_p)])


class LoongServePolicy(Policy):
    """Greedy ESP: largest-gain SP with no load-aware gate (rate=0)."""
    name = "loongserve"

    def plan(self, req, pool, now):
        group = self.sched.single_chunk_schedule(
            req.prompt_len, Allocation(), self.sched.sp_candidates, pool,
            improvement_rate=0.0)
        if group is None:
            return None
        t_q = max((pool[i] for i in group), default=0.0)
        t_p = self.model.latency(len(group), 0, req.prompt_len)
        return Allocation([Chunk(req.prompt_len, group, t_q, t_q + t_p)])


class FixedSPPolicy(Policy):
    def __init__(self, model, spec, sp: int, rate_fn=None):
        super().__init__(model, spec, rate_fn)
        self.sp = sp
        self.name = f"fixed_sp_{sp}"
        n_groups = spec.n_prefill // sp
        self.groups = [tuple(range(g * sp, (g + 1) * sp))
                       for g in range(n_groups)]

    def plan(self, req, pool, now):
        best, best_t = None, float("inf")
        for g in self.groups:
            t_q = max(pool[i] for i in g)
            if t_q < best_t:
                best, best_t = g, t_q
        t_p = self.model.latency(self.sp, 0, req.prompt_len)
        return Allocation([Chunk(req.prompt_len, best, best_t,
                                 best_t + t_p)])


def make_policy(name: str, model: PrefillLatencyModel, spec: ClusterSpec,
                rate_fn=None) -> Policy:
    if name == "tetris":
        return TetrisPolicy(model, spec, rate_fn)
    if name == "single_chunk":
        return SingleChunkPolicy(model, spec, rate_fn)
    if name in ("loongserve", "loongserve_disagg"):
        p = LoongServePolicy(model, spec, rate_fn)
        p.name = name
        return p
    if name.startswith("fixed_sp_"):
        return FixedSPPolicy(model, spec, int(name.rsplit("_", 1)[1]), rate_fn)
    raise ValueError(name)


# --------------------------------------------------------------- simulator
@dataclass
class DecodeInstance:
    """Decode-side capacity accounting, grow-on-demand token granular.

    ``slots_free`` counts tokens NOT currently resident in the KV cache —
    a request consumes its prompt at batch join and one more slot per
    generated token, releasing ``cache_tokens`` when it finishes (or is
    preempted, in the real engine).  ``virtual`` carries the worst-case
    commitments that are not yet resident: the full prompt+output of
    requests whose KV is in flight, plus each resident request's
    not-yet-generated remainder.  ``slots_free - virtual`` is therefore
    exactly the admissible worst-case headroom (identical to committing
    full budgets up front), so routing and the overcommit guard are
    unchanged while ``slots_free`` honestly reflects grow-on-demand
    residency.

    **Prefix sharing** (real engine only): when admission reuses a
    sibling's resident blocks, those tokens consume no new capacity — the
    engine calls ``credit_shared`` so ``slots_free`` (and hence routing's
    freeness) sees the true free blocks, and ``debit_shared``
    symmetrically when that request leaves.  The credit is per-request,
    so the books always drain to zero; between the *owner* leaving and
    the sharer leaving the accounting is optimistic by the still-shared
    tokens (the block-exact truth lives in BlockManager.n_free — decode-
    side exhaustion preemption covers the gap).  ``shared_tokens`` gauges
    the live credit.

    **Host swap tier** (real engine only): a swap-preempted resident
    leaves the device without giving up its request — ``swap_out`` frees
    its resident tokens and drops its ungrown commitment exactly like a
    recompute eviction, but the gauge ``swapped_tokens`` remembers the
    KV lives on the host and will return.  When the swap-in goes on the
    PCIe wire, ``swap_in_start`` books the returning tokens as virtual so
    routing cannot hand the freed space away twice mid-flight
    (``swap_in_flight`` gauges the transit); ``swap_in_done`` converts
    the commitment back into residency.  All three are exact inverses,
    so the books drain to zero however swaps interleave.
    """
    did: int
    slots_free: int
    virtual: int = 0                       # in-flight + ungrown commitments
    shared_tokens: int = 0                 # live prefix-sharing credit
    swapped_tokens: int = 0                # KV tokens parked on the host
    swap_in_flight: int = 0                # KV tokens crossing PCIe (in)
    batch: List[Request] = field(default_factory=list)
    ticking: bool = False
    backends_free: int = 8
    transfer_queue: List[Tuple[float, Request]] = field(default_factory=list)
    # mixed prefill/decode step gauges (real engine piggybacking): ticks
    # and batch tokens executed fused inside a co-resident prefill chunk's
    # step window vs as standalone timeline events, plus standalone ticks
    # that landed inside a busy window and were deferred to its end
    piggyback_ticks: int = 0
    piggyback_tokens: int = 0
    standalone_ticks: int = 0
    standalone_tokens: int = 0
    deferred_ticks: int = 0
    # cluster KV fabric hook: when set (engine, multi-instance only) the
    # instance advertises its *physical* paged-pool headroom in tokens so
    # routing sees lease-shrunken free lists, not just the slot ledger
    headroom_fn: Optional[Callable[[], int]] = None

    def freeness(self) -> float:
        free = self.slots_free - self.virtual
        if self.headroom_fn is not None:
            free = min(free, self.headroom_fn())
        return free / (len(self.batch) + 1.0)

    def credit_shared(self, tokens: int) -> None:
        """Admitted tokens served by a sibling's blocks consume no new
        capacity — give them back to the router's view."""
        self.slots_free += tokens
        self.shared_tokens += tokens

    def debit_shared(self, tokens: int) -> None:
        """Reverse ``credit_shared`` when the sharing request leaves (its
        release credited tokens that never consumed capacity)."""
        self.slots_free -= tokens
        self.shared_tokens -= tokens

    # ------------------------------------------------- host swap accounting
    def swap_out(self, req: Request, cache_tokens: int) -> None:
        """A swap-preempted resident leaves the device: resident tokens
        free up, the ungrown remainder stops being a commitment while the
        request is away, and ``swapped_tokens`` remembers it will be
        back."""
        self.slots_free += req.prompt_len + req.generated
        self.virtual -= req.output_len - req.generated
        self.swapped_tokens += cache_tokens

    def swap_in_start(self, req: Request, cache_tokens: int) -> None:
        """The swap-in goes on the wire: its resident-to-be tokens become
        a virtual commitment (like a prefill transfer's) so admission and
        routing see the space as spoken for during the PCIe flight."""
        self.virtual += req.prompt_len + req.generated
        self.swap_in_flight += cache_tokens

    def swap_in_cancel(self, req: Request, cache_tokens: int) -> None:
        """Reverse ``swap_in_start``: a resident's growth reclaimed the
        reservation; the swapped request goes back to waiting."""
        self.virtual -= req.prompt_len + req.generated
        self.swap_in_flight -= cache_tokens

    def swap_in_done(self, req: Request, cache_tokens: int) -> None:
        """Swap-in landed: the wire commitment becomes residency again —
        the exact inverse of ``swap_out`` + ``swap_in_start``."""
        self.virtual -= req.prompt_len + req.generated
        self.slots_free -= req.prompt_len + req.generated
        self.virtual += req.output_len - req.generated
        self.swapped_tokens -= cache_tokens
        self.swap_in_flight -= cache_tokens


class Simulator:
    def __init__(self, spec: ClusterSpec, policy: Policy,
                 decode_model: Optional[DecodeLatencyModel] = None,
                 trace: bool = False):
        self.spec = spec
        self.policy = policy
        self.decode_model = decode_model or DecodeLatencyModel()
        # unified telemetry (serving/telemetry.py): every lifecycle site
        # below records through the tracer.  Off by default for the pure
        # simulator — large stress sweeps pay nothing — and always on in
        # the real engine, whose log views are tracer-backed.
        self.tracer = telemetry.Tracer(enabled=trace)
        self.metrics = self.tracer.metrics
        self.free_at = {i: 0.0 for i in range(spec.n_prefill)}
        self.decodes = [DecodeInstance(d, spec.cache_slots,
                                       backends_free=spec.backends_per_decode)
                        for d in range(spec.n_decode)]
        self.events: list = []
        self.counter = itertools.count()
        self.reqs: Dict[int, Request] = {}
        self.rejected: List[int] = []
        # plan generation per request: chunk/prefill events carry the
        # generation they were scheduled under, so a preempt+requeue can
        # invalidate in-flight events without removing them from the heap
        self.plan_gen: Dict[int, int] = {}
        # booking ledger mirroring free_at: per instance, each request's
        # busy-until time; per request, its plan's (instances, end) chunks
        # in order.  Lets a requeue release the cancelled chunks' instance
        # reservations instead of leaving phantom work in free_at.
        self._inst_book: Dict[int, Dict[int, float]] = {}
        self._live_chunks: Dict[int, List[Tuple[Tuple[int, ...], float]]] = {}

    # ------------------------------------------------------------- events
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self.events, (t, next(self.counter), kind, payload))

    def run(self, requests: List[Request], horizon: float = float("inf")
            ) -> Dict[int, Request]:
        for r in requests:
            self.reqs[r.rid] = r
            self._push(r.arrival, "arrive", r.rid)
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            if t > horizon:
                break
            getattr(self, f"_on_{kind}")(t, payload)
        return self.reqs

    # ------------------------------------------------------------ prefill
    def _pool_view(self, now: float) -> Dict[int, float]:
        return {i: max(0.0, fa - now) for i, fa in self.free_at.items()}

    def _on_arrive(self, now: float, rid: int) -> None:
        req = self.reqs[rid]
        if self.tracer.enabled:
            self.tracer.record(now, "arrive", rid=rid,
                               track=("request", rid))
        self.policy.on_arrival(now)
        alloc = self.policy.plan(req, self._pool_view(now), now)
        if alloc is None:
            self.rejected.append(rid)
            if self.tracer.enabled:
                self.tracer.record(now, "reject", rid=rid,
                                   track=("request", rid))
            return
        self._commit_plan(now, req, alloc)

    def _commit_plan(self, now: float, req: Request, alloc) -> None:
        """Commit an allocation: occupy instance queues and schedule each
        chunk as its own event at the time the CDSP plan says it runs.

        Called both on arrival and (in the engine) when the remainder of a
        preempted prefill is re-planned; chunks append to the request's
        running plan and a new plan generation invalidates stale events."""
        gen = self.plan_gen[req.rid] = self.plan_gen.get(req.rid, 0) + 1
        req.phase = Phase.PREFILL
        req.chunk_plan = (req.chunk_plan or []) + [(c.length, c.sp)
                                                   for c in alloc.chunks]
        req.chunk_sched += [(now + c.t_start, now + c.t_end)
                            for c in alloc.chunks]
        req.chunk_groups += [tuple(c.instances) for c in alloc.chunks]
        req.instances = tuple(dict.fromkeys(
            req.instances + alloc.instances))
        for c in alloc.chunks:
            end = now + c.t_end
            self._live_chunks.setdefault(req.rid, []).append(
                (tuple(c.instances), end))
            for i in c.instances:
                self.free_at[i] = max(self.free_at[i], end)
                b = self._inst_book.setdefault(i, {})
                b[req.rid] = max(b.get(req.rid, 0.0), end)
        base = len(req.chunk_sched) - len(alloc.chunks)
        for k, c in enumerate(alloc.chunks):
            self._push(now + c.t_start, "chunk_start", (req.rid, base + k,
                                                        gen))
        req.prefill_done = now + alloc.ttft
        self._push(req.prefill_done, "prefill_done", (req.rid, gen))
        if self.tracer.enabled:
            self.tracer.record(now, "plan", rid=req.rid,
                               track=("request", req.rid), gen=gen,
                               n_chunks=len(alloc.chunks),
                               ttft_sched=alloc.ttft)

    def _on_chunk_start(self, now: float, payload) -> None:
        rid, ci, gen = payload
        if gen != self.plan_gen.get(rid):
            return                          # superseded by a requeue
        req = self.reqs[rid]
        req.chunk_exec.append(now)
        if self.tracer.enabled:
            s0, s1 = req.chunk_sched[ci]
            L, sp = req.chunk_plan[ci]
            group = (req.chunk_groups[ci]
                     if ci < len(req.chunk_groups) else ())
            self.tracer.record(now, "chunk", rid=rid,
                               track=("prefill",
                                      group[0] if group else 0),
                               dur=max(0.0, s1 - s0), chunk=ci, len=L,
                               sp=sp, group=tuple(group),
                               sched_start=s0, sched_end=s1)
            pool = self._pool_view(now)
            self.metrics.gauge("prefill_backlog_s").set(
                sum(pool.values()) / max(len(pool), 1), t=now)

    def _release_bookings(self, rid: int) -> None:
        """Drop a finished plan's ledger entries (free_at keeps its value;
        the ledger only exists so cancellations can recompute it)."""
        for insts, _ in self._live_chunks.pop(rid, []):
            for i in insts:
                b = self._inst_book.get(i)
                if b:
                    b.pop(rid, None)

    def _cancel_bookings(self, now: float, rid: int, executed: int) -> None:
        """Release the reservations of ``rid``'s chunks after the first
        ``executed`` ones and recompute the touched instances' free_at from
        the remaining ledger, so cancelled work stops inflating queues."""
        live = self._live_chunks.get(rid, [])
        cancelled = live[executed:]
        del live[executed:]
        touched = {i for insts, _ in cancelled for i in insts}
        for i in touched:
            b = self._inst_book.get(i, {})
            ends = [e for insts, e in live if i in insts]
            if ends:
                b[rid] = max(ends)
            else:
                b.pop(rid, None)
            self.free_at[i] = max(b.values(), default=0.0)

    def _on_prefill_done(self, now: float, payload) -> None:
        rid, gen = payload
        if gen != self.plan_gen.get(rid):
            return                          # superseded by a requeue
        self._release_bookings(rid)
        req = self.reqs[rid]
        if self.tracer.enabled and req.phase != Phase.TRANSFER:
            # first completion only: capacity-pressure retries re-fire
            # this event with the phase already TRANSFER
            self.tracer.record(now, "prefill_done", rid=rid,
                               track=("request", rid))
        if not self.spec.disaggregated:
            # LoongServe static batching: decode occupies the SP group
            sp = req.chunk_plan[-1][1]
            total = 0.0
            cache = req.prompt_len
            times = []
            for _ in range(req.output_len):
                dt = self.decode_model.latency(1, cache, sp=sp,
                                               tp=self.spec.tp_prefill)
                total += dt
                cache += 1
                times.append(now + total)
            req.token_times = times
            req.first_token = times[0]
            req.done = times[-1]
            req.generated = req.output_len
            req.phase = Phase.DONE
            # static batching: the ESP group is blocked for the whole decode
            for i in req.instances:
                self.free_at[i] = max(self.free_at[i], req.done)
            self._trace_finish(req)
            return
        # disaggregated: route to decode instance (Llumnix virtual usage)
        req.phase = Phase.TRANSFER
        need = req.prompt_len + req.output_len
        cand = [d for d in self.decodes if d.slots_free - d.virtual >= need]
        if not cand:
            # wait for slots: retry shortly (memory pressure)
            self._push(now + 0.05, "prefill_done", (rid, gen))
            return
        d = max(cand, key=DecodeInstance.freeness)
        d.virtual += need
        req.decode_instance = d.did
        # handshake: acquire a backend or queue FIFO by handshake timestamp
        if d.backends_free > 0:
            d.backends_free -= 1
            self._start_transfer(now, d, req)
        else:
            d.transfer_queue.append((now, req))

    def _trace_transfer_start(self, now: float, rid: int) -> None:
        if self.tracer.enabled:
            self.tracer.record(now, "transfer_begin", rid=rid,
                               track=("request", rid))
            self.tracer.begin("transfer", rid, now, track=("request", rid))

    def _trace_finish(self, req: Request) -> None:
        if self.tracer.enabled:
            self.tracer.record(req.done, "finish", rid=req.rid,
                               track=("request", req.rid))
            self.tracer.end_all(req.rid, req.done)
            self.metrics.hist("ttft_s").observe(req.ttft)
            for gap in req.tbts:
                self.metrics.hist("tbt_s").observe(gap)

    def _start_transfer(self, now: float, d: DecodeInstance, req: Request
                        ) -> None:
        self._trace_transfer_start(now, req.rid)
        dur = (req.prompt_len * self.spec.kv_bytes_per_token
               / self.spec.transfer_bw)
        self._push(now + dur, "transfer_done", req.rid)

    def _on_transfer_done(self, now: float, rid: int) -> None:
        req = self.reqs[rid]
        d = self.decodes[req.decode_instance]
        req.transfer_done = now
        if self.tracer.enabled:
            self.tracer.end("transfer", rid, now)
            self.tracer.record(now, "admit", rid=rid,
                               track=("request", rid),
                               instance=req.decode_instance)
            self.tracer.begin("decode_resident", rid, now,
                              track=("request", rid))
        # release backend to the FIFO queue
        if d.transfer_queue:
            t0, nxt = d.transfer_queue.pop(0)
            self._start_transfer(now, d, nxt)
        else:
            d.backends_free += 1
        # join continuous batch: grow-on-demand — only the prompt KV is
        # resident now; the output remainder stays a virtual commitment
        # that each decode tick converts into residency token by token
        d.virtual -= req.prompt_len
        d.slots_free -= req.prompt_len
        req.phase = Phase.DECODE
        d.batch.append(req)
        if not d.ticking:
            d.ticking = True
            self._push(now, "decode_tick", d.did)

    def _tick_latency(self, d: DecodeInstance) -> float:
        """Virtual-time cost of the decode step about to run on ``d``.
        The real engine overrides this to price ticks piggybacked into a
        co-resident prefill chunk step with the mixed-step term."""
        cache = sum(r.cache_tokens for r in d.batch)
        return self.decode_model.latency(len(d.batch), cache, sp=1,
                                         tp=self.spec.tp_decode)

    def _tick_mode(self, did: int) -> str:
        """Telemetry tag for the decode step about to run.  The real
        engine reports "fused" for ticks executing inline inside a
        colocated prefill chunk's step window."""
        return "standalone"

    def _on_decode_tick(self, now: float, did: int) -> None:
        d = self.decodes[did]
        if not d.batch:
            d.ticking = False
            return
        dt = self._tick_latency(d)
        t_next = now + dt
        if self.tracer.enabled:
            mode = self._tick_mode(did)
            self.tracer.record(now, "tick", track=("decode", did), dur=dt,
                               mode=mode,
                               rids=tuple(r.rid for r in d.batch))
            self.metrics.counter(f"ticks/{mode}").inc()
            self.metrics.gauge(f"decode{did}/batch").set(len(d.batch),
                                                         t=now)
        finished = []
        for r in d.batch:
            r.generated += 1
            r.token_times.append(t_next)
            if r.first_token is None:
                r.first_token = t_next
            d.slots_free -= 1              # this token's KV is now resident
            d.virtual -= 1                 # ...and no longer a commitment
            if r.generated >= r.output_len:
                finished.append(r)
        for r in finished:
            d.batch.remove(r)
            d.slots_free += r.cache_tokens
            r.phase = Phase.DONE
            r.done = t_next
            self._trace_finish(r)
        self._push(t_next, "decode_tick", did)

    def export_trace(self, path: Optional[str] = None) -> dict:
        """Build (and optionally write) the trace document: Perfetto-
        loadable ``traceEvents`` plus structured per-request records with
        TTFT attribution / TBT causes and the metrics snapshot."""
        doc = telemetry.build_trace_doc(self.tracer, self.reqs,
                                        self.metrics)
        if path is not None:
            telemetry.write_trace(path, doc)
        return doc


# ---------------------------------------------------------------- metrics
def percentile(vals: List[float], p: float) -> float:
    return float(np.percentile(vals, p)) if vals else float("nan")


def summarize(reqs: Dict[int, Request]) -> dict:
    done = [r for r in reqs.values() if r.prefill_done is not None]
    ttfts = [r.ttft for r in done]
    tbts = [tb for r in done for tb in r.tbts]
    finished = [r for r in done if r.done is not None]
    toks = sum(r.generated for r in finished)
    span = (max(r.done for r in finished) - min(r.arrival for r in finished)
            if finished else float("nan"))
    return {
        "n": len(done),
        "ttft_p50": percentile(ttfts, 50), "ttft_p99": percentile(ttfts, 99),
        "ttft_mean": float(np.mean(ttfts)) if ttfts else float("nan"),
        "tbt_p50": percentile(tbts, 50), "tbt_p99": percentile(tbts, 99),
        "throughput_tok_s": toks / span if span and span > 0 else float("nan"),
    }
