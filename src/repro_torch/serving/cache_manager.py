"""Paged KV cache: block-table accounting + physical paged storage.

Pages all the way down: the block pool is the ONLY representation of
attention KV across the whole request lifecycle.  Prefill chunks scatter
their KV into pages the moment they complete (``PagedKVCache.write_chunk``,
driven per chunk by the serving engine), cross-chunk CDSP history is read
back out of pages (ops.paged_prefill_attention), admission hands pages from
the prefill pool to a decode pool with page-granular copies
(``copy_from``), and decode attends through block tables natively.  No
dense per-request ``(B, L)`` KV tree exists at any point — the doubling of
peak memory at admission that the old ``history_to_decode_caches`` path
paid is gone.

``BlockManager`` tracks physical cache blocks per pool plus Llumnix-style
"virtual usage": slots reserved for requests whose KV is still in flight
from the prefill pool (Sec. 5.2).  The freeness rate used by the decode
router is (free - virtual) / active_batch.

Allocation is **grow-on-demand**: admission commits only the blocks that
the request's *prefilled* KV actually occupies (``reserve_virtual`` +
``commit``), and every decode step extends the allocation one block at a
time as the sequence crosses page boundaries (``extend``).  A request
therefore never holds pages for tokens it has not generated yet — the
point of paged KV (vLLM / Infinite-LLM's DistAttention).  When ``extend``
cannot be satisfied the engine preempts a victim request (recompute-style
decode preemption, see serving/engine.py) instead of over-committing.

**Prefix sharing + copy-on-write** (vLLM-style capacity multiplier):
every block carries a refcount; full blocks of admitted requests are
published under a *chained content hash* of their token ids
(``block_hashes``/``register_hashes``).  At admission the engine matches
the longest hashed prefix across residents (``match_prefix``) and commits
with ``shared=`` blocks — those blocks are referenced, not copied.  A
write into a block referenced by more than one request (a partial-block
append) must first go through ``ensure_writable``, which splits the block
copy-on-write; ``release`` decrements refs and returns only the blocks
that actually died.  ``peak_in_use`` and ``stats`` (fresh/shared/cow
counters) feed the benchmarks' prefix-hit-rate reporting.

``PagedKVCache`` is the physical side: per attention layer a block pool of
shape (n_blocks, total_blocks + 1, block_size, KVH, D) indexed through the
BlockManager's per-request block lists (Infinite-LLM-style distributed
paged layout, one pool per instance).  Block id ``total_blocks`` is a
scratch page: padded batch rows write there so inactive rows can never
corrupt live pages.  All pool writes mutate the pool tensors in place
(kernels/flash_decode.py page helpers).

In this package ``BlockManager`` is the reference's, unchanged (its striped,
head-sharded and restripe accounting included).  ``PagedKVCache`` ports
the unsharded layout and the striped one below; a sharded pool is a list
of per-shard pools, one per mesh position, driven by this one process.
The head-sharded layout and the live restripe are later slices of the
port.

**Sequence-parallel sharded pools** (``kv_shards > 1``): the pool splits
into one pool per position of a mesh axis — per layer a list of
``(n_blocks, blocks_per_shard + 1, block_size, KVH, D)`` tensors, which
stacked on axis 1 are the reference's ``(n_blocks, kv_shards, ...)`` —
and the BlockManager mirrors it with per-shard free lists.  Allocation is
*striped*: a request's i-th logical page always lives on shard
``i % kv_shards`` (its global block id satisfies ``shard_of(b) == i %
kv_shards``), so split-KV decode attends each shard's page subset with a
contiguously-valid local view and merges partial softmaxes by LSE
(core/ring_attention.sharded_paged_decode), and ring-attention prefill
rotates each shard's history pages around the ring
(core/ring_attention.ring_paged_prefill).  In steady state pages never
migrate between shards: chunk scatters, admission copies, CoW splits and
host staging all run shard by shard and keep every page on its position
(kernels/flash_decode.py sharded helpers).  Each shard
carries its own scratch page (local id ``blocks_per_shard``); the global
scratch id stays ``total_blocks``.

**Head-sharded pools** (``head_axis``, the TP×SP layout): on top of the
SP stripe the KVH dim is sharded over the TP mesh axis whenever it
divides — each device stores only ``KVH / kv_head_shards`` heads of
every page it owns, so per-device KV bytes drop exactly tp-fold for GQA
configs.  Purely a placement change: global shapes, block ids and the
stripe invariant are untouched; shard_map in/out specs carry the head
axis so chunk payloads are sliced at scatter and gathers reassemble
full-width pages for the host tier.

**Elastic striping** (``active_shards <= kv_shards``): the physical pool
layout is immutable, but the *stripe* — how many shards new pages spread
over — can shrink and grow at runtime.  ``BlockManager.restripe(n)``
remaps exactly the live pages whose owning shard changes under the new
stripe invariant (``i % n``) and returns the (old, new) global-id pairs;
``PagedKVCache.restripe`` then moves those pages between devices in one
``all_to_all`` collective per layer (the ONLY time pages cross shards).
Shards at index >= active_shards idle: their free blocks are never
taken, and the attention islands mask them to zero-length so their LSE
contributions vanish.  This is what lets the engine resize sequence
parallelism under live residents without draining (see
serving/engine.py ``request_restripe``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np


def shard_block_table(table: np.ndarray, kv_shards: int,
                      blocks_per_shard: int,
                      n_slots: Optional[int] = None) -> np.ndarray:
    """Global block table -> per-shard local tables for the sharded pool.

    ``table`` is (B, npg) int32 *global* block ids (striped: position j is
    on shard ``j % kv_shards``; the global scratch may appear anywhere as
    padding).  Returns (n_slots or kv_shards, B, ceil(npg / kv_shards))
    int32 *local* page ids, where row ``s`` column ``j`` holds the
    request's logical page ``j * kv_shards + s`` (or the shard's local
    scratch ``blocks_per_shard`` when padded / past the allocation).

    ``kv_shards`` is the *stripe* count (the pool's active shards);
    ``n_slots`` the *physical* shard count when it differs — extra rows
    are all-scratch so idle devices index only their scratch page, and
    the global scratch id is ``n_slots * blocks_per_shard``."""
    table = np.asarray(table, np.int32)
    B, npg = table.shape
    n_slots = n_slots or kv_shards
    npg_loc = -(-max(npg, 1) // kv_shards)
    scratch = n_slots * blocks_per_shard
    out = np.full((n_slots, B, npg_loc), blocks_per_shard, np.int32)
    for s in range(kv_shards):
        cols = np.arange(s, npg, kv_shards)
        g = table[:, cols]
        out[s, :, :len(cols)] = np.where(g == scratch, blocks_per_shard,
                                         g % blocks_per_shard)
    return out


def block_hashes(tokens: np.ndarray, block_size: int) -> List[int]:
    """Chained content hashes of the FULL blocks of a token sequence.

    Hash i covers tokens [0, (i+1) * block_size) by chaining on hash i-1,
    so equal hash => equal token *prefix* (up to collisions) — exactly the
    condition under which causal KV is reusable across requests.  Partial
    trailing blocks get no hash (their content is still mutable)."""
    out: List[int] = []
    h = 0
    for i in range(len(tokens) // block_size):
        blk = tokens[i * block_size:(i + 1) * block_size]
        h = hash((h,) + tuple(int(t) for t in blk))
        out.append(h)
    return out


@dataclass
class BlockManager:
    """Block accounting for one KV pool (a decode instance, or the
    engine-wide prefill pool).

    ``total_blocks`` physical blocks of ``block_size`` tokens each.
    ``allocs`` maps rid -> list of physical block ids (grown in place by
    ``extend``); a block may appear in several requests' lists when it is
    prefix-shared — ``ref`` counts the holders.  ``virtual_tokens`` maps
    rid -> tokens reserved while the request's KV is still in flight
    (counted against admission via ``can_fit``/``freeness`` but not yet
    backed by physical blocks); under prefix sharing the engine reserves
    only the tokens that need *fresh* blocks.

    With ``kv_shards > 1`` the pool mirrors a sequence-parallel sharded
    ``PagedKVCache``: one free list per shard, and allocation is striped —
    the block at position i of any allocation comes from shard ``i %
    active_shards`` (device-major ids: ``shard_of(b) = b //
    blocks_per_shard``).  Capacity checks (``can_fit``/``extend``) are
    per-shard exact, and a virtual reservation carries the stripe
    ``offset`` it will be committed at (the number of shared blocks
    preceding the fresh take) so the per-shard promise matches the
    eventual ``_take``.

    ``active_shards`` (<= kv_shards, initially equal) is the *stripe*
    width: new pages spread over shards ``0 .. active_shards - 1`` only;
    higher shards idle.  ``restripe(n)`` changes it live, remapping the
    live pages whose owning shard changes and returning the (old, new)
    id pairs for the physical move (``PagedKVCache.restripe``).

    ``_virt_shard`` is the per-physical-shard tally of blocks promised to
    pending virtual reservations, maintained incrementally on
    reserve/commit/release/update/cancel (``_virtual_by_shard()`` is the
    from-scratch recompute, kept for the property tests' equivalence
    check and for ``restripe``, which changes every reservation's stripe
    at once).
    """

    total_blocks: int
    block_size: int = 256
    kv_shards: int = 1
    # layout bookkeeping only: how many TP devices each page's KVH width
    # is sliced over (PagedKVCache head sharding).  Block ids, striping
    # and refcounts are head-agnostic — a page is one logical unit
    # whichever way its head slices are placed — so this never enters
    # allocation math; it exists so capacity accounting (per-device page
    # bytes = page_bytes / kv_head_shards) and swap staging agree with
    # the physical pool.
    kv_head_shards: int = 1
    allocs: Dict[int, List[int]] = field(default_factory=dict)
    virtual_tokens: Dict[int, int] = field(default_factory=dict)
    virtual_offset: Dict[int, int] = field(default_factory=dict)
    ref: Dict[int, int] = field(default_factory=dict)        # block -> holders
    hash_of: Dict[int, int] = field(default_factory=dict)    # block -> hash
    by_hash: Dict[int, int] = field(default_factory=dict)    # hash -> block
    tokens_of: Dict[int, tuple] = field(default_factory=dict)  # blk -> tokens
    # host-offload hook: called ONCE per release as demote_cb(dying) with
    # dying = [(block, hash, tokens), ...] for every hash-published block
    # whose last reference died, BEFORE any of them returns to the free
    # list — the engine copies all their pages to the host tier in one
    # batched device->host gather (serving/kv_offload.py)
    demote_cb: Optional[Callable[[List[Tuple[int, int, tuple]]], None]] = None
    peak_in_use: int = 0
    stats: Dict[str, int] = field(default_factory=lambda: {
        "fresh": 0, "shared": 0, "cow": 0})

    def __post_init__(self):
        assert self.total_blocks % self.kv_shards == 0, \
            (self.total_blocks, self.kv_shards)
        self.blocks_per_shard = self.total_blocks // self.kv_shards
        self.active_shards = self.kv_shards
        self.shard_free: List[List[int]] = [
            list(range(s * self.blocks_per_shard,
                       (s + 1) * self.blocks_per_shard))
            for s in range(self.kv_shards)]
        self._virt_shard: List[int] = [0] * self.kv_shards
        # cluster-fabric leases: blocks lent to a borrowing instance are
        # pulled off the free lists (never allocatable here until
        # recalled) and tracked per lease id — see grant_lease/recall
        self.leases: Dict[int, List[int]] = {}
        self._next_lease = 0
        self._metrics = None                # telemetry registry (optional)
        self._mprefix = ""

    # ----------------------------------------------------------- telemetry
    def bind_metrics(self, metrics, prefix: str = "") -> None:
        """Publish this pool's occupancy into a telemetry
        ``MetricsRegistry``: gauges ``<prefix>free_blocks`` /
        ``<prefix>effective_free`` / ``<prefix>free_shard<j>`` refresh
        whenever the books change (reserve/commit/extend/release/
        restripe)."""
        self._metrics = metrics
        self._mprefix = prefix
        self._sample()

    def _sample(self) -> None:
        m = self._metrics
        if m is None:
            return
        p = self._mprefix
        m.gauge(p + "free_blocks").set(self.n_free)
        m.gauge(p + "effective_free").set(self.effective_free())
        for s in range(self.kv_shards):
            m.gauge(f"{p}free_shard{s}").set(len(self.shard_free[s]))

    @property
    def free_blocks(self) -> List[int]:
        """Flat view of the per-shard free lists (read-only snapshot)."""
        return [b for fl in self.shard_free for b in fl]

    def shard_of(self, block: int) -> int:
        return block // self.blocks_per_shard

    def _stripe_need(self, n_blocks: int, offset: int,
                     n: Optional[int] = None) -> List[int]:
        """Blocks landing on each physical shard when taking ``n_blocks``
        at stripe positions ``offset .. offset + n_blocks - 1`` under an
        ``n``-wide stripe (default: the current active stripe).  Always
        length ``kv_shards``; idle shards get 0."""
        n = n or self.active_shards
        base, rem = divmod(n_blocks, n)
        return [base + (1 if (s - offset) % n < rem else 0)
                for s in range(n)] + [0] * (self.kv_shards - n)

    def _virtual_by_shard(self, n: Optional[int] = None) -> List[int]:
        """From-scratch recompute of ``_virt_shard`` (optionally under a
        hypothetical stripe width ``n`` — the restripe feasibility check)."""
        out = [0] * self.kv_shards
        for rid, t in self.virtual_tokens.items():
            need = self._stripe_need(self.blocks_for(t),
                                     self.virtual_offset.get(rid, 0), n)
            out = [a + b for a, b in zip(out, need)]
        return out

    def _virt_add(self, rid: int, sign: int = 1) -> None:
        need = self._stripe_need(self.blocks_for(self.virtual_tokens[rid]),
                                 self.virtual_offset.get(rid, 0))
        self._virt_shard = [a + sign * b
                            for a, b in zip(self._virt_shard, need)]

    # ------------------------------------------------------------- queries
    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` (ceil division)."""
        return -(-n_tokens // self.block_size)

    @property
    def n_free(self) -> int:
        """Physical blocks currently on the free list(s)."""
        return sum(len(fl) for fl in self.shard_free)

    @property
    def virtual_blocks(self) -> int:
        """Blocks promised to in-flight (not yet committed) requests."""
        return sum(self.blocks_for(t) for t in self.virtual_tokens.values())

    def effective_free(self) -> int:
        """Blocks a striped allocation can still actually claim: the
        tightest shard bounds everything (stripe position -> shard is
        fixed, so a pool with shard 0 exhausted fits *zero* fresh striped
        blocks no matter how free the other shards are).  min over active
        shards of (free - virtual), scaled back to global block units."""
        n = self.active_shards
        return n * min(len(self.shard_free[s]) - self._virt_shard[s]
                       for s in range(n))

    def freeness(self, batch_size: int) -> float:
        """Llumnix freeness rate: effective free blocks per batch slot.

        Uses ``effective_free`` — the naive ``n_free - virtual_blocks``
        over-reports on a striped pool with skewed shards and made the
        router admit requests that could never commit."""
        return self.effective_free() / (batch_size + 1.0)

    def can_fit(self, n_tokens: int, offset: int = 0) -> bool:
        """True if ``n_tokens`` worth of fresh blocks, taken at stripe
        position ``offset``, fit on every shard after honouring virtual
        reservations (per-shard exact — a striped pool can exhaust one
        shard while others still have room)."""
        need = self._stripe_need(self.blocks_for(n_tokens), offset)
        virt = self._virt_shard
        return all(need[s] <= len(self.shard_free[s]) - virt[s]
                   for s in range(self.active_shards))

    def can_extend(self, rid: int, n_tokens: int) -> bool:
        """True if ``extend(rid, n_tokens)`` would succeed right now."""
        need = self.blocks_for(n_tokens) - len(self.allocs[rid])
        return need <= 0 or self.can_fit(need * self.block_size,
                                         offset=len(self.allocs[rid]))

    def can_take_at(self, stripe: int) -> bool:
        """True if one fresh block is available on the shard that stripe
        position ``stripe`` maps to (the copy-on-write fit check)."""
        s = stripe % self.active_shards
        return len(self.shard_free[s]) - self._virt_shard[s] >= 1

    def grow_blocks_needed(self, rid: int, n_tokens: int) -> int:
        """Extra blocks ``rid`` needs to cover ``n_tokens`` (0 if covered)."""
        return max(0, self.blocks_for(n_tokens) - len(self.allocs[rid]))

    # ----------------------------------------------------------- lifecycle
    def _take(self, n: int, offset: int = 0) -> List[int]:
        """Pop ``n`` fresh blocks (refcount 1 each), striped from stripe
        position ``offset`` on: block i comes from shard (offset + i) %
        active_shards, preserving the position->shard invariant."""
        blocks = []
        for i in range(n):
            fl = self.shard_free[(offset + i) % self.active_shards]
            assert fl, "accounting violated"
            b = fl.pop()
            self.ref[b] = 1
            blocks.append(b)
        self.stats["fresh"] += n
        self.peak_in_use = max(self.peak_in_use,
                               self.total_blocks - self.n_free)
        return blocks

    def open(self, rid: int) -> None:
        """Start an empty allocation (the prefill pool grows it per chunk
        via ``extend``; no virtual reservation involved)."""
        self.allocs.setdefault(rid, [])

    def reserve_virtual(self, rid: int, n_tokens: int,
                        offset: int = 0) -> bool:
        """Reserve capacity for an in-flight transfer; False if it cannot
        fit (the caller retries later).  A failed reserve leaves no entry
        behind.  The engine reserves only the tokens whose KV actually
        needs fresh blocks: the prefilled length minus any prefix-shared
        blocks (grow-on-demand covers the output side).  ``offset`` is the
        stripe position the fresh take will start at — the number of
        shared blocks preceding it at commit time (it may shrink between
        reserve and commit, e.g. swap-in re-sharing: a take over a subset
        of the reserved stripe positions is always covered)."""
        if not self.can_fit(n_tokens, offset=offset):
            return False
        self.virtual_tokens[rid] = n_tokens
        self.virtual_offset[rid] = offset
        self._virt_add(rid)
        self._sample()
        return True

    def update_virtual(self, rid: int, n_tokens: int, offset: int) -> None:
        """Re-point an existing reservation (swap-in re-sharing found more
        shared blocks, so fewer fresh tokens at a later stripe offset).
        Keeps the incremental per-shard tally consistent — callers must
        not mutate ``virtual_tokens``/``virtual_offset`` directly."""
        self._virt_add(rid, -1)
        self.virtual_tokens[rid] = n_tokens
        self.virtual_offset[rid] = offset
        self._virt_add(rid)
        self._sample()

    def cancel_virtual(self, rid: int) -> None:
        """Drop a reservation without committing it (cancelled swap-in)."""
        if rid in self.virtual_tokens:
            self._virt_add(rid, -1)
            self.virtual_tokens.pop(rid, None)
            self.virtual_offset.pop(rid, None)
            self._sample()

    def commit(self, rid: int, shared: Sequence[int] = ()) -> List[int]:
        """Virtual reservation -> physical blocks (transfer complete).

        ``shared`` is a prefix of already-resident blocks discovered by
        ``match_prefix``/the engine's token compare: they are referenced
        (refcount + 1), not copied, and the fresh remainder — sized by the
        reservation, striped from position ``len(shared)`` — is popped off
        the free lists.  The engine calls reserve_virtual and commit
        within one event, so decode-side ``extend`` can never race a
        pending reservation."""
        self._virt_add(rid, -1)
        n = self.virtual_tokens.pop(rid)
        self.virtual_offset.pop(rid, None)
        for b in shared:
            self.ref[b] += 1
        self.stats["shared"] += len(shared)
        blocks = list(shared) + self._take(self.blocks_for(n),
                                           offset=len(shared))
        self.allocs[rid] = blocks
        self._sample()
        return blocks

    def extend(self, rid: int, n_tokens: int) -> bool:
        """Grow ``rid``'s allocation to cover ``n_tokens`` (decode appends
        crossing a page boundary, or the prefill pool absorbing the next
        chunk).  Mutates the allocation list in place — holders of the
        list (the engine's per-request metadata) observe the growth.
        False if the pool (any target shard) is exhausted; the engine then
        preempts."""
        need = self.blocks_for(n_tokens) - len(self.allocs[rid])
        if need <= 0:
            return True
        if not self.can_fit(need * self.block_size,
                            offset=len(self.allocs[rid])):
            # growth must not consume blocks promised to a pending
            # reservation (an in-flight swap-in holds one across events)
            return False
        self.allocs[rid] += self._take(need, offset=len(self.allocs[rid]))
        self._sample()
        return True

    def release(self, rid: int) -> List[int]:
        """Drop ``rid``'s references (and any virtual reservation).

        Returns the blocks that actually went back to the free list —
        blocks still referenced by a prefix-sharing sibling survive, along
        with their published hashes.  A dead block's hash entries are
        retired with it (sharing happens across *resident* requests only)
        — but hash-published blocks are first offered to the host tier via
        ONE ``demote_cb(dying)`` call covering every such block of this
        release (before any of them can be reallocated, so their page
        content is still intact when the callback gathers it out in a
        single batched device->host read).
        """
        freed: List[int] = []
        dying: List[Tuple[int, int, tuple]] = []
        for b in self.allocs.pop(rid, []):
            self.ref[b] -= 1
            if self.ref[b] == 0:
                del self.ref[b]
                h = self.hash_of.pop(b, None)
                toks = self.tokens_of.pop(b, None)
                if h is not None and self.by_hash.get(h) == b:
                    del self.by_hash[h]
                    if self.demote_cb is not None and toks is not None:
                        dying.append((b, h, toks))
                freed.append(b)
        if dying:
            self.demote_cb(dying)
        for b in freed:
            self.shard_free[self.shard_of(b)].append(b)
        self.cancel_virtual(rid)
        self._sample()
        return freed

    # ------------------------------------------------- prefix sharing / CoW
    def register_hashes(self, rid: int, hashes: Sequence[int],
                        tokens: Optional[Sequence[int]] = None) -> None:
        """Publish ``rid``'s full blocks under their chained content
        hashes so later admissions can match them.  Blocks that already
        carry a hash (they were themselves shared) keep it; a hash already
        published by another block keeps its first publisher.

        ``tokens`` (the token ids whose KV the blocks hold, at least
        ``len(hashes) * block_size`` of them) lets the block carry its
        content for hash-collision verification when it is later demoted
        to the host prefix tier — without it the block is still shareable
        on-device (residents confirm token-for-token) but not demotable."""
        for i, h in enumerate(hashes):
            b = self.allocs[rid][i]
            if b in self.hash_of:
                continue                   # block already published
            self.hash_of[b] = h
            self.by_hash.setdefault(h, b)
            if tokens is not None:
                self.tokens_of[b] = tuple(
                    int(t) for t in
                    tokens[i * self.block_size:(i + 1) * self.block_size])

    def match_prefix(self, hashes: Sequence[int]) -> List[int]:
        """Longest run of resident blocks matching the chained hashes.

        Chained hashing makes per-hash lookups compose: hash i can only
        match if hashes 0..i-1 matched the same chain, so the result is a
        consistent natural-order block prefix."""
        out: List[int] = []
        for h in hashes:
            b = self.by_hash.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def needs_cow(self, rid: int, idx: int) -> bool:
        """True if writing into ``rid``'s idx-th block must split it first
        (the block is referenced by another request too)."""
        return self.ref[self.allocs[rid][idx]] > 1

    def ensure_writable(self, rid: int, idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write split of ``rid``'s idx-th block when shared.

        If the block is exclusively held, returns None (write away).
        Otherwise pops a fresh block — from the shard stripe position
        ``idx`` maps to, so the copy stays device-local — drops one
        reference on the shared block (it cannot die — someone else still
        holds it) and swaps the fresh id into ``rid``'s list, returning
        ``(src, dst)`` so the caller can copy the physical page
        (PagedKVCache.copy_within).  Callers must check capacity
        (``can_take_at``, preempting if needed) before any write that may
        CoW."""
        b = self.allocs[rid][idx]
        if self.ref[b] == 1:
            return None
        new = self._take(1, offset=idx)[0]
        self.ref[b] -= 1
        self.allocs[rid][idx] = new
        self.stats["cow"] += 1
        self._sample()
        return b, new

    # ------------------------------------------------- fabric page leases
    @property
    def leased_blocks(self) -> int:
        """Blocks currently lent out to borrowing instances."""
        return sum(len(bs) for bs in self.leases.values())

    def grant_lease(self, n_blocks: int) -> Optional[int]:
        """Lend ``n_blocks`` free blocks to the cluster fabric.

        The blocks are popped off the free lists — striped like any
        allocation so the per-shard invariant stays exact — and parked
        under a lease id until ``recall_lease`` returns them.  A leased
        block is neither free nor allocated: it carries no refcount and
        no hash, and ``effective_free``/``can_fit`` see the shrunken free
        lists directly, so the donor's own admission, growth and
        watermark math never double-counts lent capacity.  Returns None
        when the take would dip into blocks promised to pending virtual
        reservations (the donor's in-flight transfers outrank lending).
        """
        if n_blocks <= 0 or not self.can_fit(n_blocks * self.block_size):
            return None
        need = self._stripe_need(n_blocks, 0)
        blocks = []
        for s in range(self.active_shards):
            for _ in range(need[s]):
                blocks.append(self.shard_free[s].pop())
        lid = self._next_lease
        self._next_lease += 1
        self.leases[lid] = blocks
        self._sample()
        return lid

    def recall_lease(self, lid: int) -> int:
        """Return a lease's blocks to their shards' free lists; the blocks
        are untouched while lent (no refcount, no hash), so recall is pure
        accounting.  Returns the number of blocks recalled."""
        blocks = self.leases.pop(lid)
        for b in blocks:
            assert b not in self.ref, f"leased block {b} was allocated"
            self.shard_free[self.shard_of(b)].append(b)
        self._sample()
        return len(blocks)

    # ------------------------------------------------- elastic restriping
    def _migrations(self, new_n: int) -> List[Tuple[int, int]]:
        """Distinct live (block, stripe position) pairs whose owning shard
        changes under an ``new_n``-wide stripe.  A block's stripe position
        is well defined even when prefix-shared: shared blocks form the
        leading run of every holder's list (and CoW replaces in place),
        so every holder sees it at the same index."""
        seen: Dict[int, int] = {}
        for blocks in self.allocs.values():
            for i, b in enumerate(blocks):
                seen[b] = i
        n = self.active_shards
        return sorted((b, i) for b, i in seen.items()
                      if i % n != i % new_n)

    def can_restripe(self, new_n: int) -> bool:
        """True if ``restripe(new_n)`` can run right now: every migrating
        page has a free destination block on its new shard, and after the
        swap every pending virtual reservation still fits under the new
        stripe.  When False the engine frees capacity (preempting the
        newest resident) and retries — the drain-free protocol never
        blocks decode while waiting."""
        assert 1 <= new_n <= self.kv_shards, (new_n, self.kv_shards)
        if new_n == self.active_shards:
            return True
        incoming = [0] * self.kv_shards
        outgoing = [0] * self.kv_shards
        for b, i in self._migrations(new_n):
            incoming[i % new_n] += 1
            outgoing[self.shard_of(b)] += 1
        if any(incoming[s] > len(self.shard_free[s])
               for s in range(self.kv_shards)):
            return False
        virt = self._virtual_by_shard(new_n)
        return all(len(self.shard_free[s]) - incoming[s] + outgoing[s]
                   >= virt[s] for s in range(new_n))

    def restripe(self, new_n: int) -> List[Tuple[int, int]]:
        """Change the stripe width to ``new_n`` shards, live.

        Every live page whose stripe position maps to a different shard
        under the new invariant gets a NEW global id popped from the free
        list of its new shard (every migration is cross-shard by
        construction: the position's old and new shards differ, and the
        old id sat on the old shard).  All bookkeeping — allocation
        lists, refcounts, published hashes, demotion tokens — follows the
        id; the old ids return to their shards' free lists.  Virtual
        reservations are re-striped wholesale (the per-shard tally is
        recomputed under the new width).  Returns the sorted (old, new)
        global-id pairs for ``PagedKVCache.restripe`` to move the
        physical pages."""
        assert self.can_restripe(new_n), (new_n, self.active_shards)
        mig = self._migrations(new_n)
        remap: Dict[int, int] = {}
        for b, i in mig:
            remap[b] = self.shard_free[i % new_n].pop()
        for blocks in self.allocs.values():
            for j, b in enumerate(blocks):
                if b in remap:
                    blocks[j] = remap[b]
        for old, new in remap.items():
            self.ref[new] = self.ref.pop(old)
            h = self.hash_of.pop(old, None)
            if h is not None:
                self.hash_of[new] = h
                if self.by_hash.get(h) == old:
                    self.by_hash[h] = new
            toks = self.tokens_of.pop(old, None)
            if toks is not None:
                self.tokens_of[new] = toks
            self.shard_free[self.shard_of(old)].append(old)
        self.active_shards = new_n
        self._virt_shard = self._virtual_by_shard()
        self._sample()
        return sorted(remap.items())


class PagedKVCache:
    """Physical paged KV pools for the attention layers of one instance.

    ``pools`` maps pattern position -> {"k","v"} tensors of shape
    (n_blocks, total_blocks + 1, block_size, KVH, D) on ``device``: the
    leading n_blocks axis matches the transformer's layer loop, so the
    engine hands the pools straight into ``forward`` as the cache tree
    (decode) or the paged history view (prefill,
    core/cdsp.pages_history_view).  Block id ``total_blocks`` is the
    scratch page.

    Every write mutates the live pool tensors in place (index assignment,
    kernels/flash_decode.py page helpers; the fused decode tick writes
    through the kernel, on a sharded pool into the owning shard's pool).
    A pool tensor is never rebound to a fresh one, so any holder of
    ``pools`` sees each write.

    With ``kv_shards > 1`` each ``pools`` leaf is a list of per-shard
    tensors (n_blocks, blocks_per_shard + 1, block_size, KVH, D), shard s
    on position s of ``shard_axis`` of ``mesh`` (several positions may
    share a card); ``torch.stack(leaf, dim=1)`` is the reference's
    (n_blocks, kv_shards, blocks_per_shard + 1, ...) layout.  Block ids
    handed in are still the BlockManager's *global* striped ids; this
    class converts them to (shard, local) internally, and each page op
    keeps every page on its shard (``flash_decode.shard_*``).  ``device``
    is then position 0's device, where block tables and gathered pages
    land.
    """

    def __init__(self, cfg, total_blocks: int, block_size: int,
                 dtype: Optional[str] = None, kv_shards: int = 1,
                 mesh=None, shard_axis: Optional[str] = None,
                 head_axis: Optional[str] = None, device=None):
        import torch
        from repro_torch.models.sharding import resolve_device
        if head_axis is not None:
            raise NotImplementedError(
                "head-sharded pools (TPxSP) are a later slice of the port")
        self.cfg = cfg
        self.total_blocks = total_blocks
        self.block_size = block_size
        self.kv_shards = kv_shards
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.head_axis = None
        self.kv_head_shards = 1
        self.scratch_block = total_blocks       # global scratch id
        self.attn_layers = [i for i, s in enumerate(cfg.pattern)
                            if s.mixer == "attn"]
        dt = getattr(torch, dtype or cfg.dtype)
        nb, kvh, dh = cfg.n_blocks, cfg.n_kv_heads, cfg.head_dim_
        if kv_shards == 1:
            self.blocks_per_shard = total_blocks
            self.device = resolve_device(device)     # CUDA unless asked
            shape = (nb, total_blocks + 1, block_size, kvh, dh)
            make = lambda: torch.zeros(shape, dtype=dt, device=self.device)
        else:
            if mesh is None or shard_axis is None:
                raise ValueError("a sharded pool needs a mesh and an axis "
                                 "to shard over")
            if total_blocks % kv_shards:
                raise ValueError(f"{total_blocks} blocks do not stripe "
                                 f"over {kv_shards} shards")
            self.shard_devices = mesh.positions(shard_axis)
            if len(self.shard_devices) != kv_shards:
                raise ValueError(f"axis {shard_axis!r} of {mesh} has "
                                 f"{len(self.shard_devices)} positions, "
                                 f"not {kv_shards}")
            self.device = self.shard_devices[0]
            self.blocks_per_shard = total_blocks // kv_shards
            # one scratch page PER SHARD (local id blocks_per_shard)
            shape = (nb, self.blocks_per_shard + 1, block_size, kvh, dh)
            make = lambda: [torch.zeros(shape, dtype=dt, device=d)
                            for d in self.shard_devices]
        self.pools = {str(i): {"k": make(), "v": make()}
                      for i in self.attn_layers}

    def _ids(self, ids) -> "torch.Tensor":
        import torch
        return torch.as_tensor(list(ids), dtype=torch.long,
                               device=self.device)

    # -------------------------------------------------- sharded id helpers
    def _local(self, block: int) -> Tuple[int, int]:
        """Global block id -> (shard, local page id)."""
        if block == self.scratch_block:
            return 0, self.blocks_per_shard
        return divmod(block, self.blocks_per_shard)

    def _group_by_shard(self, blocks: Sequence[int]
                        ) -> Tuple[np.ndarray, List[List[int]]]:
        """Group global ids by shard: returns (kv_shards, m_max) local ids
        (scratch-padded) plus, per shard, the original positions of its
        entries — so callers can route per-position payloads."""
        n = self.kv_shards
        local: List[List[int]] = [[] for _ in range(n)]
        idxs: List[List[int]] = [[] for _ in range(n)]
        for j, b in enumerate(blocks):
            s, l = self._local(int(b))
            local[s].append(l)
            idxs[s].append(j)
        m = max((len(l) for l in local), default=0) or 1
        out = np.full((n, m), self.blocks_per_shard, np.int32)
        for s in range(n):
            out[s, :len(local[s])] = local[s]
        return out, idxs

    # ------------------------------------------------------------- prefill
    def write_chunk(self, blocks: List[int], new_caches: dict,
                    positions, active: Optional[int] = None) -> None:
        """Scatter ONE prefill chunk's KV into the request's pages as the
        chunk completes.  ``new_caches`` is the chunk's forward() output
        tree (attention entries hold only this chunk's KV, (nb, 1, L, KVH,
        D)); ``positions`` the chunk's position array (1, L).  Tokens land
        at their logical position, so pages stay in natural order.  On a
        striped pool each shard writes the tokens of the pages it owns
        under an ``active``-wide stripe (default: every shard)."""
        from repro_torch.kernels.flash_decode import (scatter_kv_chunk,
                                                      shard_scatter_kv_chunk)
        if not self.attn_layers:
            return
        pos2d = positions[0] if positions.dim() == 3 else positions
        pos = pos2d[0].to(self.device)
        if self.kv_shards > 1:
            act = active or self.kv_shards
            if any(self._local(int(b))[0] != j % act
                   for j, b in enumerate(blocks)):
                raise RuntimeError(f"stripe drift: {blocks} do not stripe "
                                   f"over {act} shards")
            lp = shard_block_table(np.asarray(blocks, np.int32)[None], act,
                                   self.blocks_per_shard,
                                   n_slots=self.kv_shards)[:, 0]
            for i in self.attn_layers:
                ent = new_caches[str(i)]["self"]
                for part in ("k", "v"):
                    shard_scatter_kv_chunk(self.pools[str(i)][part], lp,
                                           ent[part][:, 0], pos, active=act)
            return
        blk = self._ids(blocks)
        for i in self.attn_layers:
            ent = new_caches[str(i)]["self"]
            scatter_kv_chunk(self.pools[str(i)]["k"], blk, ent["k"][:, 0], pos)
            scatter_kv_chunk(self.pools[str(i)]["v"], blk, ent["v"][:, 0], pos)

    # ----------------------------------------------------- page migration
    def copy_from(self, src, src_blocks: Iterable[int],
                  dst_blocks: Iterable[int]) -> None:
        """Adopt whole pages from another pool, page-granular: another
        ``PagedKVCache`` (prefill -> decode admission), the host tier
        (``kv_offload.HostKVPool``: swap-in, prefix promotion) or a peer
        gather (``kv_fabric`` wraps ``read_blocks`` output).  Host sources
        are sliced on the host first, so only the needed pages cross to
        the device.  Between pools striped over the same shard count the
        copy is position-local (logical page i sits on shard ``i %
        kv_shards`` in both); other sources are regrouped per shard."""
        from repro_torch.kernels.flash_decode import (copy_kv_blocks,
                                                      scatter_kv_blocks,
                                                      shard_gather_kv_blocks)
        src_list = [int(b) for b in src_blocks]
        dst_list = [int(b) for b in dst_blocks]
        if not src_list:
            return
        if self.kv_shards > 1:
            self._copy_from_sharded(src, src_list, dst_list)
            return
        dst_ids = self._ids(dst_list)
        if getattr(src, "kv_shards", 1) > 1:
            # sharded source -> unsharded destination: per-shard gather,
            # reorder into logical order, scatter
            local, idxs = src._group_by_shard(src_list)
            m = local.shape[1]
            flat = np.zeros(len(src_list), np.int64)
            for s in range(src.kv_shards):
                for t, j in enumerate(idxs[s]):
                    flat[j] = s * m + t
            for i in self.attn_layers:
                for part in ("k", "v"):
                    g = shard_gather_kv_blocks(src.pools[str(i)][part],
                                               local, self.device)
                    pages = g.reshape((g.shape[0], -1) + g.shape[3:])
                    scatter_kv_blocks(self.pools[str(i)][part], dst_ids,
                                      pages[:, self._ids(flat)])
            return
        for i in self.attn_layers:
            for part in ("k", "v"):
                sp = src.pools[str(i)][part]
                if isinstance(src, PagedKVCache):
                    copy_kv_blocks(self.pools[str(i)][part], sp,
                                   src._ids(src_list), dst_ids)
                else:
                    scatter_kv_blocks(self.pools[str(i)][part], dst_ids,
                                      sp[:, src_list])

    def _copy_from_sharded(self, src, src_list: List[int],
                           dst_list: List[int]) -> None:
        """``copy_from`` into a striped pool.  Three source layouts: a
        pool striped over the same shard count (position-local page
        copies), the host tier (per-shard page slices uploaded), and an
        unsharded device pool (pages gathered, then regrouped per
        shard)."""
        import torch
        from repro_torch.kernels.flash_decode import (gather_kv_blocks,
                                                      shard_copy_kv_blocks,
                                                      shard_scatter_kv_blocks)
        n = self.kv_shards
        dst_local, dst_idxs = self._group_by_shard(dst_list)
        m = dst_local.shape[1]
        if getattr(src, "kv_shards", 1) > 1:
            if src.kv_shards != n:
                raise ValueError(
                    f"cannot copy pages between pools sharded {src.kv_shards}"
                    f"-way and {n}-way: stripe layouts do not line up")
            # stripe alignment makes every pair same-shard: regroup the
            # src ids by the DST grouping and check the shards agree
            # (padding slots copy the source's scratch page onto ours)
            src_local = np.full((n, m), src.blocks_per_shard, np.int32)
            for s in range(n):
                for t, j in enumerate(dst_idxs[s]):
                    ss, sl = src._local(src_list[j])
                    if ss != s:
                        raise RuntimeError("cross-shard page copy "
                                           "(stripe drift)")
                    src_local[s, t] = sl
            for i in self.attn_layers:
                for part in ("k", "v"):
                    shard_copy_kv_blocks(self.pools[str(i)][part],
                                         src.pools[str(i)][part],
                                         src_local, dst_local)
            return
        # host tier or unsharded device pool: per-shard payloads
        # (nb, n, m, page, KVH, D) in dst grouping order; padding slots
        # carry the first page onto the shard's scratch page (harmless)
        idx = np.zeros((n, m), np.int64)
        for s in range(n):
            idx[s, :len(dst_idxs[s])] = dst_idxs[s]
        device_src = isinstance(src, PagedKVCache)
        for i in self.attn_layers:
            for part in ("k", "v"):
                sp = src.pools[str(i)][part]
                if device_src:
                    g = gather_kv_blocks(sp, src._ids(src_list))
                    pages = g[:, torch.as_tensor(idx, device=g.device)]
                else:
                    pages = sp[:, [src_list[j] for j in idx.reshape(-1)]]
                    pages = pages.reshape((pages.shape[0], n, m)
                                          + pages.shape[2:])
                shard_scatter_kv_blocks(self.pools[str(i)][part], dst_local,
                                        pages)

    def read_blocks(self, blocks: Iterable[int]) -> Dict[str, dict]:
        """Gather whole pages into host (CPU) tensors — the staging read
        of a swap-out or host demotion.  Layout mirrors the pools:
        {layer: {"k"/"v": (nb, n, page, KVH, D)}}, consumable by
        ``kv_offload.HostKVPool.store``.  A striped pool gathers per shard
        and the pages are put back in logical order on the host."""
        import torch
        from repro_torch.kernels.flash_decode import (gather_kv_blocks,
                                                      shard_gather_kv_blocks)
        ids_list = [int(b) for b in blocks]
        if self.kv_shards > 1:
            local, idxs = self._group_by_shard(ids_list)
            order = np.zeros(len(ids_list), np.int64)
            for s in range(self.kv_shards):
                for t, j in enumerate(idxs[s]):
                    order[j] = s * local.shape[1] + t
            order = torch.as_tensor(order)
            out = {}
            for i in self.attn_layers:
                ent = {}
                for part in ("k", "v"):
                    g = shard_gather_kv_blocks(self.pools[str(i)][part],
                                               local, torch.device("cpu"))
                    ent[part] = g.reshape((g.shape[0], -1)
                                          + g.shape[3:])[:, order]
                out[str(i)] = ent
            return out
        ids = self._ids(ids_list)
        return {str(i): {part: gather_kv_blocks(
                    self.pools[str(i)][part], ids).cpu()
                for part in ("k", "v")}
                for i in self.attn_layers}

    def copy_within(self, src_block: int, dst_block: int) -> None:
        """Duplicate one page inside the pool — the physical half of a
        copy-on-write split (BlockManager.ensure_writable).  On a striped
        pool source and destination sit on one shard (the replacement
        comes from the same stripe position)."""
        from repro_torch.kernels.flash_decode import (
            copy_kv_block_within, shard_copy_kv_block_within)
        if self.kv_shards > 1:
            ss, sl = self._local(int(src_block))
            ds, dl = self._local(int(dst_block))
            if ss != ds:
                raise RuntimeError("a copy-on-write split must stay on one "
                                   "shard")
            src = np.full((self.kv_shards,), self.blocks_per_shard, np.int32)
            dst = src.copy()
            src[ss], dst[ss] = sl, dl
            for i in self.attn_layers:
                for part in ("k", "v"):
                    shard_copy_kv_block_within(self.pools[str(i)][part],
                                               src, dst)
            return
        for i in self.attn_layers:
            for part in ("k", "v"):
                copy_kv_block_within(self.pools[str(i)][part],
                                     int(src_block), int(dst_block))

    def restripe(self, pairs: Sequence[Tuple[int, int]]) -> None:
        """Move the pages of a live stripe resize to their new shards
        (``BlockManager.restripe``'s pairs).  An unsharded pool has none
        to move; the cross-shard move itself (the reference's
        ``shard_restripe_kv_blocks``) is a later slice of the port."""
        if pairs:
            raise NotImplementedError(
                "elastic restripe (shard_restripe_kv_blocks, "
                "PagedKVCache.restripe) is a later slice of the port")

    # -------------------------------------------------------------- decode
    def adopt(self, new_caches: dict) -> None:
        """Fold one decode step's pools back in.  The fused tick wrote each
        new token's K/V into the live pools in place, so the tree hands
        back these very tensors (or per-shard lists); anything else is a
        fault."""
        for i in self.attn_layers:
            ent = new_caches[str(i)]["self"]
            for part in ("k", "v"):
                if ent[part] is not self.pools[str(i)][part]:
                    raise RuntimeError(
                        "decode returned a fresh pool tensor; the paged "
                        "pools must be written in place")
