"""CDSP scheduling — faithful implementation of the paper's Algorithms 1-3.

Algorithm 1 (CDSPSchedule): recursive chunk-plan exploration.  Algorithm 2
(SingleChunkSchedule): SP-size selection with the load-aware improvement-rate
gate.  Algorithm 3 (GetChunkPlan): chunk sizing against the queue-gap budget
via the Eq. (1) latency model (closed-form quadratic solve).

Instance pools are plain dicts {instance_id: queue_seconds}; node topology is
{instance_id: node_id}.  All times are relative to "now" at scheduling time.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.latency_model import PrefillLatencyModel


@dataclass(frozen=True)
class Chunk:
    length: int
    instances: Tuple[int, ...]
    t_start: float               # = max queue delay of the group (absolute)
    t_end: float                 # = t_start + prefill latency

    @property
    def sp(self) -> int:
        return len(self.instances)


@dataclass
class Allocation:
    chunks: List[Chunk] = field(default_factory=list)

    @property
    def ttft(self) -> float:
        return self.chunks[-1].t_end if self.chunks else 0.0

    @property
    def total_length(self) -> int:
        return sum(c.length for c in self.chunks)

    @property
    def instances(self) -> Tuple[int, ...]:
        seen: List[int] = []
        for c in self.chunks:
            for i in c.instances:
                if i not in seen:
                    seen.append(i)
        return tuple(seen)


class CDSPScheduler:
    def __init__(self, model: PrefillLatencyModel,
                 sp_candidates: Optional[Sequence[int]] = None,
                 nodes: Optional[Dict[int, int]] = None,
                 node_size: int = 8,
                 min_chunk_tokens: int = 2048,
                 improvement_rate: float = 0.3,
                 piggyback_overhead: float = 0.0):
        self.model = model
        self.sp_candidates = tuple(sorted(sp_candidates or model.sp_sizes))
        self.nodes = nodes                    # instance -> node
        self.node_size = node_size
        self.min_chunk_tokens = min_chunk_tokens
        self.improvement_rate = improvement_rate
        # mixed prefill/decode steps (serving/engine.py piggybacking):
        # expected seconds of piggybacked decode work fused into each chunk
        # step.  Eq. (1) pricing then (a) shrinks the queue-gap budget a
        # chunk may fill, leaving room for the decode ticks, and (b) widens
        # every chunk window by the same amount so downstream queue-delay
        # estimates stay honest.  0.0 = pure-prefill pricing (default).
        self.piggyback_overhead = piggyback_overhead

    # ------------------------------------------------------------ topology
    def _node_of(self, i: int) -> int:
        return self.nodes[i] if self.nodes is not None else i // self.node_size

    def _by_node(self, pool: Dict[int, float]) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for i in pool:
            out.setdefault(self._node_of(i), []).append(i)
        for v in out.values():
            v.sort(key=lambda i: (pool[i], i))
        return out

    # ----------------------------------------------------- group extension
    def get_group(self, pool: Dict[int, float], initial: Tuple[int, ...],
                  s: int) -> Optional[Tuple[int, ...]]:
        """Extend ``initial`` to a nested group of size ``s`` (paper's
        GetGroup).  Returns None if infeasible."""
        if s < len(initial) or s > len(pool):
            return None
        if s == len(initial):
            return tuple(initial)
        chosen = list(initial)
        remaining = {i: t for i, t in pool.items() if i not in set(chosen)}
        by_node = self._by_node(remaining)

        def pick_intra_node(nodes_avail: Dict[int, List[int]], need: int
                            ) -> Optional[List[int]]:
            """Node with minimal need-th shortest queue -> its shortest
            ``need`` instances (avoids cross-node fragmentation)."""
            best = None
            for n, insts in nodes_avail.items():
                if len(insts) >= need:
                    cand = insts[:need]
                    key = remaining[cand[-1]]
                    if best is None or key < best[0]:
                        best = (key, cand)
            return best[1] if best else None

        if chosen:
            # (2) first fill up nodes already hosting the initial group
            host_nodes = {self._node_of(i) for i in chosen}
            fill = sorted((i for n in host_nodes for i in by_node.get(n, [])),
                          key=lambda i: (remaining[i], i))
            take = fill[:s - len(chosen)]
            chosen += take
            for i in take:
                by_node[self._node_of(i)].remove(i)

        need = s - len(chosen)
        if need == 0:
            return tuple(chosen)
        # (1) fresh selection over free nodes
        if need <= self.node_size:
            got = pick_intra_node(by_node, need)
            if got is not None:
                return tuple(chosen + got)
        # span k full nodes + remainder
        full_nodes = [n for n, v in by_node.items() if len(v) >= self.node_size]
        full_nodes.sort(key=lambda n: max(remaining[i]
                                          for i in by_node[n][:self.node_size]))
        k = need // self.node_size
        if len(full_nodes) < k:
            # fall back: greedily take the globally shortest queues
            flat = sorted(remaining, key=lambda i: (remaining[i], i))
            if len(flat) < need:
                return None
            return tuple(chosen + flat[:need])
        for n in full_nodes[:k]:
            chosen += by_node[n][:self.node_size]
            by_node[n] = by_node[n][self.node_size:]
        rem = need - k * self.node_size
        if rem:
            got = pick_intra_node(
                {n: v for n, v in by_node.items()
                 if n not in set(full_nodes[:k])}, rem)
            if got is None:
                flat = sorted((i for v in by_node.values() for i in v),
                              key=lambda i: (remaining[i], i))
                if len(flat) < rem:
                    return None
                got = flat[:rem]
            chosen += got
        return tuple(chosen)

    # --------------------------------------------------------- Algorithm 2
    def single_chunk_schedule(self, L: int, alloc: Allocation,
                              sp_sizes: Sequence[int],
                              pool: Dict[int, float],
                              improvement_rate: Optional[float] = None,
                              cached_tokens: int = 0
                              ) -> Optional[Tuple[int, ...]]:
        rate = self.improvement_rate if improvement_rate is None else improvement_rate
        C = alloc.total_length + cached_tokens
        initial = alloc.instances
        opt_ttft, opt_group = float("inf"), None
        for s in sorted(sp_sizes):
            if s not in self.model.coeffs:
                continue
            group = self.get_group(pool, initial, s)
            if group is None:
                continue
            t_queue = max((pool[i] for i in group), default=0.0)
            t_prefill = self.model.latency(s, C, L) + self.piggyback_overhead
            ttft = t_queue + t_prefill
            # expand SP only when the gain clears the load-aware threshold
            if ttft < opt_ttft * (1.0 - rate):
                opt_ttft, opt_group = ttft, group
        return opt_group

    # --------------------------------------------------------- Algorithm 3
    def get_chunk_plan(self, L: int, alloc: Allocation, s_cur: int,
                       s_next: int, pool: Dict[int, float],
                       cached_tokens: int = 0) -> Optional[Chunk]:
        C = alloc.total_length + cached_tokens
        initial = alloc.instances
        cur_group = self.get_group(pool, initial, s_cur)
        if cur_group is None:
            return None
        next_group = self.get_group(pool, cur_group, s_next)
        if next_group is None:
            return None
        t_q_cur = max((pool[i] for i in cur_group), default=0.0)
        t_q_next = max((pool[i] for i in next_group), default=0.0)
        # the piggybacked decode ticks ride inside this chunk's step, so
        # they consume part of the queue-gap budget the chunk may fill
        budget = t_q_next - t_q_cur - self.piggyback_overhead
        l_chunk = int(min(L, self.model.solve_chunk_len(s_cur, C, budget)))
        if l_chunk <= 0 or l_chunk < self.min_chunk_tokens or l_chunk >= L:
            return None                        # illegal plan (Alg. 1 line 11)
        t_prefill = self.model.latency(s_cur, C, l_chunk) \
            + self.piggyback_overhead
        return Chunk(l_chunk, cur_group, t_q_cur, t_q_cur + t_prefill)

    # --------------------------------------------------------- Algorithm 1
    def schedule(self, L: int, pool: Dict[int, float],
                 alloc: Optional[Allocation] = None,
                 sp_sizes: Optional[Sequence[int]] = None,
                 improvement_rate: Optional[float] = None,
                 cached_tokens: int = 0,
                 _depth: int = 0) -> Optional[Allocation]:
        """Returns the optimal CDSP allocation for a request of L tokens.

        ``cached_tokens`` is prompt-prefix context whose KV already exists
        (host prefix cache promotion): no chunk is planned for it, but
        every chunk's Eq. (1) latency attends over it as history, so the
        plan prices the real mid-prompt start."""
        alloc = alloc or Allocation()
        sp_sizes = tuple(sp_sizes or self.sp_candidates)

        # Step 0: initial single-chunk plan
        group = self.single_chunk_schedule(L, alloc, sp_sizes, pool,
                                           improvement_rate, cached_tokens)
        if group is None:
            return None
        C = alloc.total_length + cached_tokens
        t_q = max((pool[i] for i in group), default=0.0)
        t_p = self.model.latency(len(group), C, L) + self.piggyback_overhead
        opt = Allocation(alloc.chunks + [Chunk(L, group, t_q, t_q + t_p)])

        # Step 1: chunk-plan exploration
        s_cdsp = [s for s in sp_sizes if s <= len(group)]
        if len(s_cdsp) <= 1 or _depth > 8:
            return opt
        for s_cur, s_next in itertools.combinations(sorted(s_cdsp), 2):
            plan = self.get_chunk_plan(L, alloc, s_cur, s_next, pool,
                                       cached_tokens)
            if plan is None:
                continue
            offset = plan.t_end
            pool2 = {i: max(0.0, t - offset) for i, t in pool.items()}
            alloc2 = Allocation(alloc.chunks + [plan])
            s2 = [s for s in s_cdsp if s >= s_next]
            sub = self.schedule(L - plan.length, pool2, alloc2, s2,
                                improvement_rate, cached_tokens,
                                _depth=_depth + 1)
            if sub is None:
                continue
            # shift the recursion's relative times back to absolute
            fixed = alloc.chunks + [plan] + [
                Chunk(c.length, c.instances, c.t_start + offset,
                      c.t_end + offset)
                for c in sub.chunks[len(alloc2.chunks):]]
            cand = Allocation(fixed)
            if cand.ttft < opt.ttft:
                opt = cand
        return opt

    # ------------------------------------------------------------- commit
    @staticmethod
    def apply(pool: Dict[int, float], alloc: Allocation) -> None:
        """Commit an allocation: every instance in a chunk's group is busy
        until that chunk completes."""
        for c in alloc.chunks:
            for i in c.instances:
                pool[i] = max(pool[i], c.t_end)
