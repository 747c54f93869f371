"""Simulator-based improvement-rate profiler (Sec. 5.1, Sec. 6).

The request length distribution of long-context services is stable over
days/weeks, so the optimal SP-expansion threshold ("improvement rate") per
arrival rate is profiled OFFLINE: sample requests at each rate, simulate
prefill with Eq. (1), and pick the rate minimising mean TTFT.  Online, the
scheduler monitors the arrival rate over a sliding window and looks up the
nearest profiled rate (paper: refreshed every 30 s; rates span 0.05-0.75).
"""

from __future__ import annotations

import bisect
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.latency_model import PrefillLatencyModel
from repro_torch.serving.simulator import (ClusterSpec, Simulator, TetrisPolicy,
                                     summarize)
from repro_torch.serving.workload import make_trace

DEFAULT_RATES = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.75)


def profile_improvement_rates(
        model: PrefillLatencyModel, spec: ClusterSpec, trace: str,
        arrival_rates: Sequence[float],
        improvement_rates: Sequence[float] = DEFAULT_RATES,
        duration: float = 300.0, seed: int = 0,
        objective: str = "ttft_mean") -> Dict[float, float]:
    """For each arrival rate, find the improvement rate minimising TTFT."""
    table: Dict[float, float] = {}
    for ar in arrival_rates:
        reqs_proto = make_trace(trace, ar, duration, seed=seed)
        best, best_val = improvement_rates[0], float("inf")
        for ir in improvement_rates:
            reqs = [type(r)(rid=r.rid, arrival=r.arrival,
                            prompt_len=r.prompt_len, output_len=r.output_len)
                    for r in reqs_proto]
            sim = Simulator(spec, TetrisPolicy(model, spec,
                                               rate_fn=lambda now: ir))
            out = sim.run(reqs)
            val = summarize(out)[objective]
            if np.isfinite(val) and val < best_val:
                best, best_val = ir, val
        table[ar] = best
    return table


@dataclass
class DynamicRateController:
    """Online controller: sliding-window arrival-rate estimate -> profiled
    optimal improvement rate (nearest recorded arrival rate).

    The serving engine additionally reports the prefill pool's queue
    backlog at every chunk boundary (``observe_queue``).  With
    ``queue_gain > 0`` the profiled rate is scaled up under backlog — a
    higher improvement-rate threshold suppresses speculative SP expansion
    exactly when the pool is congested.  ``queue_gain = 0`` (default) keeps
    the paper-faithful arrival-rate-only behaviour."""
    table: Dict[float, float]
    window: float = 30.0
    default: float = 0.3
    queue_gain: float = 0.0
    _arrivals: Deque[float] = field(default_factory=deque)
    _queue_obs: Deque[tuple] = field(default_factory=deque)  # (t, backlog s)
    _keys: Optional[List[float]] = None

    def observe(self, t: float) -> None:
        self._arrivals.append(t)

    def observe_queue(self, t: float, backlog: float) -> None:
        """Record the mean per-instance queue backlog (seconds) seen at a
        chunk boundary.  Trims here (not only in queue_pressure) so the
        buffer stays bounded even when queue_gain is 0."""
        lo = t - self.window
        while self._queue_obs and self._queue_obs[0][0] < lo:
            self._queue_obs.popleft()
        self._queue_obs.append((t, backlog))

    def queue_pressure(self, now: float) -> float:
        """Mean observed backlog (seconds) over the sliding window."""
        lo = now - self.window
        while self._queue_obs and self._queue_obs[0][0] < lo:
            self._queue_obs.popleft()
        if not self._queue_obs:
            return 0.0
        return sum(b for _, b in self._queue_obs) / len(self._queue_obs)

    def sp_decision(self, now: float, candidates: Sequence[int],
                    current: int) -> int:
        """Target live stripe width for the elastically restriped paged
        pools (serving/engine.py ``request_restripe``), one candidate step
        at a time.  Sustained queue backlog (> 1.5 s mean over the window)
        steps DOWN — wide sequence parallelism is a latency optimisation
        whose per-chunk communication is wasted under congestion — and a
        near-empty window (< 0.5 s) steps back UP for latency.  One step
        per decision keeps each resize's page-migration volume small."""
        cands = sorted({int(c) for c in candidates if c >= 1} | {current})
        i = cands.index(current)
        p = self.queue_pressure(now)
        if p > 1.5 and i > 0:
            return cands[i - 1]
        if p < 0.5 and i + 1 < len(cands):
            return cands[i + 1]
        return current

    def decode_budget(self, now: float,
                      base: Optional[int]) -> Optional[int]:
        """Decode-token budget per mixed prefill/decode step (the engine's
        Sarathi-style piggybacking knob).  Sustained prefill backlog
        (> 1.5 s mean over the window) suppresses piggybacking entirely —
        the chunk's slack goes to draining the queue — while moderate
        backlog (> 0.5 s) halves the configured budget.  A calm window
        passes ``base`` through unchanged (``None`` = unbounded)."""
        p = self.queue_pressure(now)
        if p > 1.5:
            return 0
        if p > 0.5 and base is not None:
            return base // 2
        return base

    def rate(self, now: float) -> float:
        base = self._table_rate(now)
        if self.queue_gain > 0.0:
            base = min(0.95, base * (1.0 + self.queue_gain
                                     * self.queue_pressure(now)))
        return base

    def _table_rate(self, now: float) -> float:
        if not self.table:
            return self.default
        lo = now - self.window
        while self._arrivals and self._arrivals[0] < lo:
            self._arrivals.popleft()
        if not self._arrivals:
            return self.default
        ar = len(self._arrivals) / self.window
        if self._keys is None:
            self._keys = sorted(self.table)
        i = bisect.bisect_left(self._keys, ar)
        cands = self._keys[max(0, i - 1):i + 1]
        key = min(cands, key=lambda k: abs(k - ar))
        return self.table[key]
