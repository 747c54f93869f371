"""Request lifecycle objects shared by the simulator and the real engine."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class Phase(enum.Enum):
    QUEUED = 0
    PREFILL = 1
    TRANSFER = 2
    DECODE = 3
    DONE = 4
    # swap-preempted: KV parked in the host offload tier, waiting to swap
    # back into a decode instance (serving/kv_offload.py) — unlike a
    # recompute preemption the request does NOT re-enter QUEUED/PREFILL
    SWAPPED = 5


@dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    output_len: int
    phase: Phase = Phase.QUEUED
    # metrics
    prefill_done: Optional[float] = None
    transfer_done: Optional[float] = None
    first_token: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    done: Optional[float] = None
    # runtime state
    decode_instance: Optional[int] = None
    generated: int = 0
    chunk_plan: Optional[list] = None      # [(length, sp)] actually used
    instances: tuple = ()                  # prefill instances used
    # chunk-granular execution: scheduled (start, end) per chunk, absolute
    # event-clock times, the time each chunk actually executed, and the
    # instance group each chunk runs on (mixed prefill/decode steps need
    # the per-chunk group to find co-resident decode instances)
    chunk_sched: List[tuple] = field(default_factory=list)
    chunk_exec: List[float] = field(default_factory=list)
    chunk_groups: List[tuple] = field(default_factory=list)
    preemptions: int = 0                   # mid-prefill preempt/requeue count
    # prompt-prefix tokens whose KV the host prefix cache already holds at
    # planning time: the chunk planner prices chunks as running over this
    # much pre-existing context (the engine promotes the pages and starts
    # the prefill mid-prompt — serving/engine.py planner skip)
    cached_tokens: int = 0

    @property
    def ttft(self) -> Optional[float]:
        # paper Sec 2.2: arrival -> finish of prefill computation
        return None if self.prefill_done is None else \
            self.prefill_done - self.arrival

    @property
    def tbts(self) -> List[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    @property
    def cache_tokens(self) -> int:
        return self.prompt_len + self.generated
