"""Cluster-wide KV memory fabric: cross-instance swap placement, page
borrow/lend, and a global two-tier prefix cache.

Until this module, KV memory was instance-local even though the cluster
is one pool of schedulable compute (the point of CDSP): a swapped victim
had to resume on the instance it left, device-tier prefix sharing only
matched within one instance's pool, and an instance at its watermark
preempted even when a neighbor had idle pages.  Infinite-LLM's
DistAttention / distributed KVCache makes the case that *where KV lives*
should decouple from *where it computes*; LoongServe's elastic-SP
fragments are exactly the idle-page pockets a cluster tier can harvest.
``KVFabric`` is that tier — it owns what used to be the engine's host
plumbing (``HostKVPool`` / ``HostPrefixCache`` / ``SwapManager``) plus a
registry of every decode instance's ``BlockManager``/``PagedKVCache``,
and exposes three capabilities:

* **Placed swap-in** — ``best_resume_target`` scores every instance for
  a parked swap record: modeled PCIe swap-in time, plus an interconnect
  term (``core/latency_model.InterconnectModel``) when the pages would
  land on a non-origin instance, plus a destination queue-depth term
  (the victim's first token back waits on the resident batch's ticks).
  The engine migrates the record to the winner and the victim resumes
  there token-for-token — greedy decode depends only on the request's
  own cache, so placement is invisible to the token stream.

* **Page borrow/lend** — before the engine's ``_grow_or_preempt`` evicts
  a victim for dipping under the *watermark* (policy headroom, not
  physical exhaustion), the fabric leases free blocks out of a donor
  instance's pool (``BlockManager.grant_lease`` — the donor's
  ``effective_free`` drops per-shard-exactly) and credits the borrower's
  watermark floor by the same amount.  Cluster-wide headroom can live
  anywhere because placed swap-in lets the *next* victim resume
  anywhere; physical exhaustion still preempts (pages cannot be attended
  across pools).  Leases recall on donor pressure — before the donor
  itself would preempt — and release when the borrower's pressure
  subsides.

* **Global prefix promotion** — ``match_peer_chain`` continues a chained
  hash match past the local run across *peer* device pools
  (token-verified, like every sharing path), and ``peer_pages`` stages
  the hit pages through a ``read_blocks`` gather so any
  ``PagedKVCache.copy_from`` can adopt them — admission on instance A
  promotes a chain resident on instance B over the interconnect.  The
  engine's planner applies a ``choose_preempt_policy``-style cost gate:
  peer-copy only when the modeled interconnect time undercuts the
  modeled prefill time of the covered tokens.

With one instance — or ``fabric="off"`` — every capability degenerates
to the pre-fabric path: ``cross_instance`` is False, the engine never
calls the placement/borrow/peer hooks, and ``swap_stats``/``preempt_log``
are byte-identical to the instance-local engine.  Counters
(placed vs pinned swap-ins, leases out/recalled, peer promotions,
interconnect bytes) publish through ``bind_metrics`` as ``fabric/*``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.latency_model import (HostOffloadModel, InterconnectModel)
from repro_torch.serving.kv_offload import (HostKVPool, HostPrefixCache,
                                      SwapManager, SwapRecord)


class _PeerPages:
    """A ``read_blocks`` gather presented as a ``copy_from`` source.

    ``read_blocks`` returns CPU tensors of exactly the gathered pages in
    request order — layer -> {"k"/"v": (nb, n, page, KVH, D)} — which is
    the host-pool layout ``PagedKVCache.copy_from`` already consumes (a
    host source, positional page slicing).  Wrapping it with positional
    block ids ``0..n-1`` turns any cross-pool page move into the existing
    host-promotion code path: no new kernels, and the destination-side
    scatter works for unsharded and sharded pools alike.  So a peer move
    travels card -> pageable host memory -> card, both copies
    synchronous, where the event clock models one interconnect hop
    (``InterconnectModel``)."""

    def __init__(self, pools: Dict[str, dict]):
        self.pools = pools


@dataclass
class _Lease:
    """One active borrow: ``n_blocks`` of watermark headroom moved from
    ``donor`` (whose free lists physically shrank — BlockManager lease
    ``lid``) to ``borrower`` (whose watermark floor is credited)."""
    donor: int
    borrower: int
    lid: int
    n_blocks: int


class KVFabric:
    """Cluster-scoped KV memory owner for one serving engine.

    Owns the host tier (swap records + LRU second-tier prefix cache) and
    a registry of every decode instance's block books and physical pool.
    ``cross_instance`` gates the cluster behaviors: False (single
    instance, or fabric forced off) keeps every path bit-identical to
    the instance-local engine."""

    def __init__(self, cfg, spec, block_size: int,
                 host_pool_blocks: int,
                 offload_model: Optional[HostOffloadModel] = None,
                 interconnect: Optional[InterconnectModel] = None,
                 cross_instance: bool = False):
        self.block_size = block_size
        self.kv_bytes_per_token = spec.kv_bytes_per_token
        self.interconnect = interconnect or InterconnectModel()
        self.cross_instance = cross_instance
        if host_pool_blocks > 0:
            self.host = HostKVPool(cfg, host_pool_blocks, block_size,
                                   dtype=cfg.dtype)
            self.host_cache = HostPrefixCache(self.host)
            self.swap = SwapManager(self.host,
                                    offload_model or HostOffloadModel(),
                                    spec.kv_bytes_per_token)
        else:
            self.host = None
            self.host_cache = None
            self.swap = None
        # instance registry (engine fills it as dstates come up)
        self.dstates: List = []
        self.insts: List = []
        self.leases: List[_Lease] = []
        self.counters: Dict[str, float] = {
            "swap_in_placed": 0, "swap_in_pinned": 0,
            "leases_out": 0, "leases_recalled": 0,
            "lease_blocks_out": 0, "lease_blocks_recalled": 0,
            "peer_promotions": 0, "peer_promoted_blocks": 0,
            "interconnect_bytes": 0.0}
        # per-instance breakdown surfacing which instance is thrashing
        # (engine swap_stats' engine-wide counters hide it)
        self.per_instance: Dict[int, Dict[str, float]] = {}
        self._metrics = None
        self._mprefix = ""

    # ------------------------------------------------------------ registry
    def register_instance(self, did: int, dstate, inst) -> None:
        """Register one decode instance's paged state (BlockManager +
        PagedKVCache + TransferManager) and simulator-side books."""
        assert did == len(self.dstates), (did, len(self.dstates))
        self.dstates.append(dstate)
        self.insts.append(inst)
        self.per_instance[did] = {
            "swap_outs": 0, "swap_ins": 0, "swap_in_placed": 0,
            "swap_in_pinned": 0, "lent_blocks": 0, "borrowed_blocks": 0,
            "peer_promotions_src": 0}

    # ----------------------------------------------------------- telemetry
    def bind_metrics(self, metrics, prefix: str = "fabric/") -> None:
        """Publish the fabric counters into a telemetry registry:
        ``fabric/swap_in_placed`` / ``fabric/swap_in_pinned`` counters,
        a ``fabric/leases_active`` gauge (blocks currently lent), and
        counters for leases out/recalled, peer promotions and
        interconnect bytes."""
        self._metrics = metrics
        self._mprefix = prefix
        metrics.gauge(prefix + "leases_active").set(self.leased_blocks)

    def _bump(self, key: str, n: float = 1) -> None:
        self.counters[key] += n
        if self._metrics is not None:
            self._metrics.counter(self._mprefix + key).inc(n)

    def _sample_leases(self) -> None:
        if self._metrics is not None:
            self._metrics.gauge(self._mprefix + "leases_active").set(
                self.leased_blocks)

    # ------------------------------------------------------ placed swap-in
    def best_resume_target(self, rec: SwapRecord,
                           watermark_fn: Callable[[object], int],
                           queue_s_fn: Callable[[int], float]
                           ) -> Optional[int]:
        """Best instance for a parked swap record to resume on, or None
        when no instance can take it right now (the engine retries).

        Feasibility per instance: a free batch row and watermark headroom
        over the record's block need — the same admission bar the pinned
        path applies to the origin.  Cost = modeled PCIe swap-in time
        + ``InterconnectModel.transfer_time`` when the pages would land
        off-origin (they were staged from the origin's pool) + the
        destination's queue-depth term (resident batch × modeled tick
        seconds, ``queue_s_fn``) — the same congestion term
        ``choose_preempt_policy`` now prices.  Ties keep the origin, so
        an idle symmetric cluster behaves exactly like the pinned path."""
        n_bytes = self.swap.block_bytes(len(rec.host_blocks))
        pcie_s = self.swap.model.swap_time(n_bytes)
        origin = rec.origin_did if rec.origin_did is not None else rec.did
        order = [origin] + [i for i in range(len(self.dstates))
                            if i != origin]
        best, best_cost = None, float("inf")
        for did in order:
            d, inst = self.dstates[did], self.insts[did]
            need = d.blocks.blocks_for(rec.cache_len)
            floor = min(need + watermark_fn(d), d.blocks.total_blocks)
            if d.free_slot() is None or d.blocks.effective_free() < floor:
                continue
            cost = pcie_s + len(inst.batch) * queue_s_fn(did)
            if did != origin:
                cost += self.interconnect.transfer_time(n_bytes)
            if cost < best_cost:
                best, best_cost = did, cost
        return best

    def note_swap_in(self, rec: SwapRecord) -> None:
        """Count a landed swap-in as placed (resumed off-origin — the
        pages crossed the interconnect) or pinned (origin resume, the
        pre-fabric behavior), per instance and engine-wide."""
        origin = rec.origin_did if rec.origin_did is not None else rec.did
        pi = self.per_instance.get(rec.did)
        if pi is not None:
            pi["swap_ins"] += 1
        if rec.did != origin:
            self._bump("swap_in_placed")
            n_bytes = self.swap.block_bytes(len(rec.host_blocks))
            self._bump("interconnect_bytes", n_bytes)
            if pi is not None:
                pi["swap_in_placed"] += 1
            self.dstates[rec.did].transfers.note_interconnect(
                "placed", n_bytes)
        else:
            self._bump("swap_in_pinned")
            if pi is not None:
                pi["swap_in_pinned"] += 1

    def note_swap_out(self, did: int) -> None:
        pi = self.per_instance.get(did)
        if pi is not None:
            pi["swap_outs"] += 1

    # ------------------------------------------------------- borrow / lend
    @property
    def leased_blocks(self) -> int:
        """Blocks currently lent across the fabric (all active leases)."""
        return sum(l.n_blocks for l in self.leases)

    def credit(self, did: int) -> int:
        """Watermark-floor credit instance ``did`` currently holds from
        borrowed leases: the engine's ``_grow_or_preempt`` subtracts it
        from the watermark before choosing a victim."""
        return sum(l.n_blocks for l in self.leases if l.borrower == did)

    def borrow(self, borrower: int, n_blocks: int,
               watermark_fn: Callable[[object], int]) -> int:
        """Lease ``n_blocks`` of headroom from the amplest donor.

        A donor qualifies when lending still leaves it *two* watermarks
        of effective free blocks — one it must keep for its own policy
        floor, one of slack so the loan isn't recalled the next tick.
        The blocks physically leave the donor's free lists
        (``BlockManager.grant_lease``); the borrower gets a floor credit,
        not pages — cross-pool attention is impossible without new
        kernels, so only *headroom* migrates, and that is all the
        watermark ever was.  Returns the blocks credited (0: no donor)."""
        best, best_room = None, -1
        for did, d in enumerate(self.dstates):
            if did == borrower:
                continue
            room = d.blocks.effective_free() - 2 * watermark_fn(d) \
                - n_blocks
            if room >= 0 and room > best_room:
                best, best_room = did, room
        if best is None:
            return 0
        lid = self.dstates[best].blocks.grant_lease(n_blocks)
        if lid is None:
            return 0
        self.leases.append(_Lease(best, borrower, lid, n_blocks))
        self._bump("leases_out")
        self._bump("lease_blocks_out", n_blocks)
        self.per_instance[best]["lent_blocks"] += n_blocks
        self.per_instance[borrower]["borrowed_blocks"] += n_blocks
        # the grant is a control-plane handshake on the interconnect —
        # no page content moves (headroom, not pages-in-use)
        self.dstates[best].transfers.note_interconnect("lease", 0.0)
        self._sample_leases()
        return n_blocks

    def _recall(self, lease: _Lease) -> None:
        self.dstates[lease.donor].blocks.recall_lease(lease.lid)
        self.leases.remove(lease)
        self._bump("leases_recalled")
        self._bump("lease_blocks_recalled", lease.n_blocks)
        self.per_instance[lease.donor]["lent_blocks"] -= lease.n_blocks
        self.per_instance[lease.borrower]["borrowed_blocks"] \
            -= lease.n_blocks
        self._sample_leases()

    def recall_from_donor(self, donor: int) -> int:
        """Recall every lease granted BY ``donor`` — called when the
        donor itself comes under pressure, before it preempts any of its
        own residents (lent headroom outranks a victim falling).  The
        blocks return to the donor's free lists; the borrowers' floor
        credit vanishes, so their next growth re-checks honestly.
        Returns blocks recalled."""
        out = 0
        for lease in [l for l in self.leases if l.donor == donor]:
            out += lease.n_blocks
            self._recall(lease)
        return out

    def release_borrowed(self, borrower: int, spare_blocks: int) -> int:
        """Return leases held by ``borrower`` once its own pressure has
        subsided: while it has ``spare_blocks`` of effective free above
        its (uncredited) watermark, it doesn't need the loan.  Recalls
        greedily, largest lease first.  Returns blocks returned."""
        out = 0
        for lease in sorted([l for l in self.leases
                             if l.borrower == borrower],
                            key=lambda l: -l.n_blocks):
            if spare_blocks - out < lease.n_blocks:
                break
            out += lease.n_blocks
            self._recall(lease)
        return out

    # ------------------------------------------------ global prefix chain
    def match_peer_chain(self, exclude_did: Optional[int],
                         hashes: Sequence[int], seq: np.ndarray,
                         start: int) -> Tuple[Optional[int], List[int]]:
        """Longest token-verified run of *peer*-resident blocks
        continuing a chained hash match past position ``start``.

        ``hashes`` are the request's chained block hashes from ``start``
        on (local device + host tiers covered ``[0, start)``); the chain
        is matched against every registered instance except
        ``exclude_did`` through its ``BlockManager.by_hash`` index, and
        each hit must match the publisher's stored token content
        (``tokens_of``) — the same collision-proofing every sharing path
        applies.  Returns ``(did, blocks)`` of the longest run, or
        ``(None, [])``."""
        bs = self.block_size
        best_did, best = None, []
        for did, d in enumerate(self.dstates):
            if did == exclude_did:
                continue
            bm = d.blocks
            out: List[int] = []
            for i, b in enumerate(bm.match_prefix(hashes)):
                lo = (start + i) * bs
                want = tuple(int(t) for t in seq[lo:lo + bs])
                if bm.tokens_of.get(b) != want:
                    break
                out.append(b)
            if len(out) > len(best):
                best_did, best = did, out
        return best_did, best

    def peer_pages(self, did: int, blocks: Sequence[int]) -> _PeerPages:
        """Stage peer instance ``did``'s pages for adoption: one batched
        gather (``read_blocks``) wrapped as a positional ``copy_from``
        source.  The caller scatters with ``copy_from(peer_pages,
        range(n), dst_blocks)`` and accounts the interconnect bytes via
        ``note_peer_promotion``."""
        return _PeerPages(self.dstates[did].kv.read_blocks(blocks))

    def peer_copy_cost(self, n_blocks: int) -> float:
        """Modeled seconds to move ``n_blocks`` pages across the
        interconnect — the peer-copy side of the planner's
        peer-copy vs host-promote vs recompute cost gate."""
        n_bytes = n_blocks * self.block_size * self.kv_bytes_per_token
        return self.interconnect.transfer_time(n_bytes)

    def note_peer_promotion(self, src_did: int, transfers,
                            n_blocks: int) -> None:
        """Account one peer prefix promotion: ``n_blocks`` pages crossed
        the interconnect out of ``src_did``'s pool.  ``transfers`` is the
        ``TransferManager`` to book the move on — the engine passes the
        *source* instance's, since the promotion lands in the prefill
        pool, which keeps no transfer books of its own."""
        n_bytes = n_blocks * self.block_size * self.kv_bytes_per_token
        self._bump("peer_promotions")
        self._bump("peer_promoted_blocks", n_blocks)
        self._bump("interconnect_bytes", n_bytes)
        self.per_instance[src_did]["peer_promotions_src"] += 1
        transfers.note_interconnect("peer_promote", n_bytes)
