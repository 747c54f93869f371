"""The system under test and the loop that drives it on the wall clock.

``build_engine`` builds the port's ``ServingEngine`` as
``repro_torch.launch.serve.serve`` does (the Tetris policy over
``table1_model()``, 16 prefill instances with SP candidates 1/2/4/8),
with the settings of the cell's traffic file: one decode instance
colocated with every prefill instance, and explicit page pools.
Piggybacking is off: the engine's decode budget counts tokens, so a
fused step with a few resident rows runs tens of ~80-ms ticks inside
one chunk event (PERF.md).

``Pump`` is a copy of ``ServingEngine.serve``'s loop — pop ``(t, seq,
kind, payload)`` from ``eng.events`` and call ``eng._on_<kind>(t,
payload)`` — that also submits each request when it comes due on the
wall clock (with ``arrival`` the engine's current event time, so the
modelled clock never holds back a request that is already due) and
stamps on the wall clock each request's due time, its first chunk's
start and every token as it appears in ``eng.outputs``.  The engine
members it relies on: ``events``, ``submit``, ``outputs``, ``chunk_log``,
``dstates[*].meta`` and the ``_on_<kind>`` handlers (``_on_decode_tick``
is wrapped on the instance to stamp each tick).
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from traffic import Job


def build_engine(cfg, params, ctx, eng_cfg: dict, profile_ops: bool):
    """The engine of the cell (``eng_cfg``: the traffic file's
    ``engine``)."""
    from repro_torch.core.latency_model import table1_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.simulator import ClusterSpec, make_policy
    n_prefill = int(eng_cfg["prefill_instances"])
    max_batch, max_seq = int(eng_cfg["max_batch"]), int(eng_cfg["max_seq"])
    spec = ClusterSpec(n_prefill=n_prefill, n_decode=1,
                       sp_candidates=tuple(eng_cfg["sp_candidates"]),
                       cache_slots=max_batch * max_seq)
    policy = make_policy(eng_cfg["policy"], table1_model(), spec)
    page = int(eng_cfg["page_tokens"])
    return ServingEngine(
        cfg, params, spec, policy, ctx=ctx, max_batch=max_batch,
        max_seq=max_seq, block_size=page,
        prefill_pool_blocks=int(eng_cfg["prefill_pool_tokens"]) // page,
        host_pool_blocks=int(eng_cfg["host_pool_tokens"]) // page,
        decode_hosts={0: tuple(range(n_prefill))},
        piggyback=False, profile_ops=profile_ops)


@dataclass
class Stamps:
    """Wall-clock seconds after the window opened, per request (by the
    engine's request id)."""
    due: Dict[int, float] = field(default_factory=dict)
    submitted: Dict[int, float] = field(default_factory=dict)
    first_chunk: Dict[int, float] = field(default_factory=dict)
    tokens: Dict[int, List[float]] = field(default_factory=dict)
    out_len: Dict[int, int] = field(default_factory=dict)
    # (kind, start, end) of every event the pump dispatched; (start, end,
    # tokens produced, the resident rows' cache lengths before it) of every
    # decode tick
    events: List[tuple] = field(default_factory=list)
    ticks: List[tuple] = field(default_factory=list)
    tick_cpu: List[float] = field(default_factory=list)  # thread CPU s
    # (rid, offset, length, start) of every chunk that ran, in order
    chunks: List[tuple] = field(default_factory=list)
    sleeps: List[tuple] = field(default_factory=list)

    def finished(self, rid: int) -> bool:
        return len(self.tokens.get(rid, ())) >= self.out_len[rid]


class Pump:
    """Drives ``eng`` on the wall clock ``clock`` (seconds)."""

    def __init__(self, eng, clock: Callable[[], float] = time.perf_counter):
        self.eng = eng
        self.clock = clock
        self.t0 = 0.0
        self.eng_t = 0.0                 # the last popped event's time
        self.st = Stamps()
        self.seen: Dict[int, int] = {}   # rid -> tokens stamped
        self._tick = eng._on_decode_tick
        eng._on_decode_tick = self._stamped_tick
        self.rid_of: Dict[int, Job] = {}
        self.on_step: Optional[Callable[[float], None]] = None

    def now(self) -> float:
        return self.clock() - self.t0

    # ------------------------------------------------------------ stamping
    def _stamp(self, rid: int, t: float) -> int:
        n = len(self.eng.outputs.get(rid, ()))
        k = n - self.seen.get(rid, 0)
        if k > 0 and rid in self.st.tokens:
            self.st.tokens[rid].extend([t] * k)
        if k > 0:
            self.seen[rid] = n
        return max(k, 0)

    def _stamped_tick(self, now: float, did: int) -> None:
        meta = self.eng.dstates[did].meta
        rows = list(meta)
        lens = [m.cache_len for m in meta.values()]
        w0, c0 = self.now(), time.thread_time()
        self._tick(now, did)
        w1 = self.now()
        self.st.tick_cpu.append(time.thread_time() - c0)
        n = sum(self._stamp(r, w1) for r in rows)
        self.st.ticks.append((w0, w1, n, lens))

    def _after_chunk(self, rid: int, w0: float, w1: float,
                     before: int) -> None:
        log = self.eng.chunk_log.get(rid, [])
        if len(log) > before:
            off = sum(c["len"] for c in log[:-1])
            self.st.chunks.append((rid, off, log[-1]["len"], w0))
            if rid in self.st.due and rid not in self.st.first_chunk:
                self.st.first_chunk[rid] = w0
        self._stamp(rid, w1)

    # ---------------------------------------------------------- submission
    def submit(self, job: Job, rid: int, due: float) -> None:
        from repro_torch.serving.request import Request
        req = Request(rid=rid, arrival=self.eng_t, prompt_len=job.prompt_len,
                      output_len=job.output_len)
        self.eng.submit(req, job.prompt)
        self.rid_of[rid] = job
        self.st.due[rid] = due
        self.st.submitted[rid] = self.now()
        self.st.tokens[rid] = []
        # the engine's stream: the first token, then one a decode tick
        self.st.out_len[rid] = job.output_len + 1

    def step(self) -> bool:
        """Dispatch the next event; False when the heap is empty."""
        if not self.eng.events:
            return False
        t, _, kind, payload = heapq.heappop(self.eng.events)
        self.eng_t = t
        rid = payload[0] if kind == "chunk_start" else None
        before = len(self.eng.chunk_log.get(rid, ())) if rid is not None \
            else 0
        w0 = self.now()
        getattr(self.eng, f"_on_{kind}")(t, payload)
        w1 = self.now()
        self.st.events.append((kind, w0, w1))
        if rid is not None:
            self._after_chunk(rid, w0, w1, before)
        return True

    def drain(self) -> None:
        """Serve until the heap is empty (the warm-up)."""
        while self.step():
            pass

    # ----------------------------------------------------------- the window
    def run(self, jobs: List[Job], seconds: float,
            drain_cap: float) -> float:
        """Open the window now and serve ``jobs``, each at its due time.
        Arrivals stop when the window closes; then the run serves until
        every request due in the window has its last token, or until
        ``drain_cap`` seconds after the close.  Returns the seconds from
        the window's open to the run's end."""
        self.t0 = self.clock()
        queue = list(jobs)
        rid = 0
        while True:
            now = self.now()
            if self.on_step is not None:
                self.on_step(now)
            while queue and queue[0].due <= now:
                job = queue.pop(0)
                self.submit(job, rid, job.due)
                rid += 1
            if not queue and all(self.st.finished(r) for r in self.st.due):
                return now
            if now >= seconds + drain_cap:
                return now
            if self.step():
                continue
            if queue:
                wait = queue[0].due - self.now()
                if wait > 0:
                    t = self.now()
                    time.sleep(wait)
                    self.st.sleeps.append((t, self.now()))
            else:
                # nothing to dispatch while requests are in flight: only a
                # stuck engine gets here, and the drain cap ends the run
                time.sleep(1e-3)
