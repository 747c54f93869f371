"""Host-memory KV offload tier: swap-to-host preemption + a second-tier
prefix cache.

Until this module, the engine's only pressure valve was *recompute*
preemption: on block-pool exhaustion a victim's KV was dropped and its
generated prefix re-prefilled — burning prefill FLOPs exactly when the
cluster is saturated.  Infinite-LLM's memory tiering and LoongServe's
proactive KV migration both make the same observation: long-context
capacity comes from *moving* KV across memory tiers, not dropping it.
This module adds that tier:

* ``HostKVPool`` — block-granular numpy host buffers mirroring the device
  ``PagedKVCache`` layout (per attention layer ``(nb, total_blocks, page,
  KVH, D)``), with the same free-list accounting.  Pages move device->host
  through ``PagedKVCache.read_blocks`` (``kernels/flash_decode.
  gather_kv_blocks``) and host->device through ``PagedKVCache.copy_from``
  (``scatter_kv_blocks``, host pages sliced before they cross PCIe).
* ``SwapManager`` — bookkeeping for swap-preempted residents: per-request
  ``SwapRecord`` (host blocks + the ``_DecodeMeta`` fields needed to
  resume token-for-token), swap byte/counter accounting, and the
  ``HostOffloadModel`` PCIe term (core/latency_model.py) used to schedule
  swap-out/swap-in completion as simulator events that overlap ongoing
  decode ticks.
* ``HostPrefixCache`` — an LRU second-tier prefix cache over the host
  pool: when ``BlockManager.release`` retires a hash-published block, the
  engine demotes its page here instead of losing it; a later admission
  whose chained hashes (and token content — ``hash()`` is not
  collision-proof) match promotes the pages back page-granularly, so
  prefix sharing survives eviction.
* ``choose_preempt_policy`` — the ``auto`` knob's cost compare: modeled
  swap-in time (PCIe) vs modeled recompute time (prefill Eq. 1 over the
  victim's resume sequence), per victim.

The engine wiring lives in serving/engine.py (``preempt_policy``,
``_swap_out`` / ``swap_in_try`` / ``swap_in_done`` events,
``_demote_block``); ``DecodeInstance`` carries the in-flight swap gauges
(serving/simulator.py) and ``TransferManager`` the PCIe byte accounting
(serving/transfer.py).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.latency_model import HostOffloadModel, PrefillLatencyModel


class HostKVPool:
    """Block-granular host KV buffers mirroring the device pool.

    Layout matches ``PagedKVCache`` minus the scratch page: per attention
    layer ``{"k"/"v": (nb, total_blocks, block_size, KVH, D)}`` CPU
    tensors in the pool's dtype (page-locked when a CUDA device is
    present, so page copies to and from the card can run asynchronously),
    so device<->host moves are whole-page slices and
    ``PagedKVCache.copy_from`` can consume this pool directly as a
    promotion source.  Accounting is a plain free list — host blocks are
    never shared or refcounted (each swap record / cache entry owns its
    blocks outright)."""

    def __init__(self, cfg, total_blocks: int, block_size: int,
                 dtype: Optional[str] = None):
        import torch
        self.total_blocks = total_blocks
        self.block_size = block_size
        self.attn_layers = [i for i, s in enumerate(cfg.pattern)
                            if s.mixer == "attn"]
        dt = getattr(torch, dtype or cfg.dtype)
        nb, kvh, dh = cfg.n_blocks, cfg.n_kv_heads, cfg.head_dim_
        shape = (nb, total_blocks, block_size, kvh, dh)
        pin = torch.cuda.is_available()
        self.pools = {str(i): {"k": torch.zeros(shape, dtype=dt,
                                                pin_memory=pin),
                               "v": torch.zeros(shape, dtype=dt,
                                                pin_memory=pin)}
                      for i in self.attn_layers}
        self.free_blocks: List[int] = list(range(total_blocks))
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self.free_blocks)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` host blocks, or None when the tier is full (the
        caller may evict prefix-cache entries and retry — swap records
        are never evicted from under a swapped request)."""
        if n > self.n_free:
            return None
        blocks = [self.free_blocks.pop() for _ in range(n)]
        self.peak_in_use = max(self.peak_in_use,
                               self.total_blocks - self.n_free)
        return blocks

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            assert b not in self.free_blocks, f"double-free host block {b}"
            self.free_blocks.append(b)

    def store(self, blocks: Sequence[int], data: Dict[str, dict]) -> None:
        """Land gathered device pages (``PagedKVCache.read_blocks``
        output, (nb, len(blocks), page, KVH, D) per layer/part) into the
        host blocks."""
        ids = list(blocks)
        for i in self.attn_layers:
            for part in ("k", "v"):
                self.pools[str(i)][part][:, ids] = data[str(i)][part]


def choose_preempt_policy(
        n_blocks: int, block_size: int, kv_bytes_per_token: float,
        resume_tokens: int, prefill_model: PrefillLatencyModel,
        offload_model: HostOffloadModel,
        cached_tokens: int = 0, queue_depth: int = 0,
        queue_ms: float = 0.0) -> Tuple[str, float, float]:
    """The ``auto`` preemption policy's per-victim cost compare.

    Returns ``(policy, swap_in_ms, recompute_ms)``: the modeled PCIe time
    to bring the victim's ``n_blocks`` resident pages back from host vs
    the modeled prefill time (Eq. 1, best SP, no history) to recompute its
    ``resume_tokens``-long resume sequence.  Short prefixes recompute
    almost for free; long ones are exactly where recompute burns the
    FLOPs the saturated cluster needs — swap wins there.

    ``cached_tokens`` is the prefix of the resume sequence whose pages the
    host prefix cache already holds: on a recompute path their KV comes
    back as a page-granular promotion at admission, so the recompute
    estimate prices only the uncached remainder's prefill plus the PCIe
    promotion of the cached pages — without this discount ``auto``
    over-prefers swap exactly for the victims whose prefix survived an
    earlier eviction.

    ``queue_depth`` × ``queue_ms`` is the destination congestion term:
    a swap-in resumes into a live decode batch, so the victim's first
    token back waits on the destination's already-resident ticks — the
    raw PCIe price alone makes a swap into a saturated instance beat
    recompute on paper while losing on observed TTFT.  The engine feeds
    the resume target's batch depth and its modeled per-tick latency;
    recompute re-enters through admission routing, which already picks
    the freest instance, so only the swap side pays."""
    n_bytes = n_blocks * block_size * kv_bytes_per_token
    swap_ms = offload_model.swap_time(n_bytes) * 1e3
    swap_ms += max(queue_depth, 0) * queue_ms
    cached = min(max(cached_tokens, 0), resume_tokens)
    L = max(resume_tokens - cached, 1)
    rec_ms = prefill_model.latency(
        prefill_model.optimal_sp(L), 0.0, L) * 1e3
    if cached:
        promo_bytes = -(-cached // block_size) * block_size \
            * kv_bytes_per_token
        rec_ms += offload_model.swap_time(promo_bytes) * 1e3
    return ("swap" if swap_ms < rec_ms else "recompute"), swap_ms, rec_ms


@dataclass
class SwapRecord:
    """Everything needed to resume a swap-preempted resident
    token-for-token: its host pages plus the ``_DecodeMeta`` fields —
    generated tokens stay in ``ServingEngine.outputs`` untouched, and the
    non-attention aux tree (SSD state, conv windows, cross KV) rides
    here as-is (it is O(1) in sequence length)."""
    rid: int
    did: int                         # decode instance it swaps back into
    host_blocks: List[int]
    cache_len: int
    last_token: int
    tokens: List[int]
    aux: Optional[dict]
    row: Optional[int] = None        # batch row claimed by an in-flight
    #                                  swap-in (None while parked / when a
    #                                  resident's growth cancels the claim)
    origin_did: Optional[int] = None  # instance the victim swapped out of;
    #                                   with the KV fabric, ``did`` may be
    #                                   re-pointed at a better resume
    #                                   target ("placed" vs "pinned")


class SwapManager:
    """Swap-preemption bookkeeping for one engine.

    Owns the PCIe cost model and the swap records; byte movement itself
    is orchestrated by the engine (which also accounts it per instance on
    ``TransferManager``).  ``counters`` feed ``ServingEngine.swap_stats``
    and the engine-fidelity benchmark's host-offload segment."""

    def __init__(self, pool: HostKVPool, model: HostOffloadModel,
                 kv_bytes_per_token: float):
        self.pool = pool
        self.model = model
        self.kv_bytes_per_token = kv_bytes_per_token
        self.records: Dict[int, SwapRecord] = {}
        self.counters = {"swap_outs": 0, "swap_ins": 0,
                         "bytes_out": 0.0, "bytes_in": 0.0,
                         "fallback_recompute": 0,
                         "swap_in_shared_blocks": 0}

    def block_bytes(self, n_blocks: int) -> float:
        """Wire bytes for ``n_blocks`` whole pages (one direction) — the
        single page-size formula shared with the NIC-side accounting."""
        from repro_torch.serving.transfer import TransferManager
        return TransferManager.swap_bytes(n_blocks, self.pool.block_size,
                                          self.kv_bytes_per_token)


@dataclass
class _CacheEntry:
    block: int                       # host block holding the page
    tokens: tuple                    # token ids — collision verification


class HostPrefixCache:
    """LRU second-tier prefix cache over the host pool.

    Maps a block's *chained content hash* (cache_manager.block_hashes) to
    its demoted host page.  Entries are inserted when
    ``BlockManager.release`` retires a hash-published block (the engine's
    ``demote_cb``) and matched at admission as a chain continuation past
    the device-resident prefix — each hit is verified token-for-token
    against the stored content, mirroring ``plan_share``'s
    collision-proofing.  The cache is best-effort: swap-outs and newer
    demotions evict LRU entries, and a promotion *copies* the page back
    (the entry stays — one demoted prefix can serve many admissions)."""

    def __init__(self, pool: HostKVPool):
        self.pool = pool
        self.entries: "OrderedDict[int, _CacheEntry]" = OrderedDict()
        self.stats = {"demotions": 0, "hits": 0, "evictions": 0,
                      "rejected": 0}
        self._metrics = None
        self._mprefix = ""

    def bind_metrics(self, metrics, prefix: str = "") -> None:
        """Mirror ``stats`` increments into telemetry counters
        (``<prefix>demotions`` / ``hits`` / ``evictions`` / ``rejected``)
        and keep a ``<prefix>entries`` gauge of the cache size."""
        self._metrics = metrics
        self._mprefix = prefix
        metrics.gauge(prefix + "entries").set(len(self.entries))

    def _bump(self, key: str, n: int = 1) -> None:
        self.stats[key] += n
        if self._metrics is not None:
            self._metrics.counter(self._mprefix + key).inc(n)
            self._metrics.gauge(self._mprefix + "entries").set(
                len(self.entries))

    def __len__(self) -> int:
        return len(self.entries)

    def _evict_lru(self) -> None:
        _, ent = self.entries.popitem(last=False)
        self.pool.free([ent.block])
        self._bump("evictions")

    def evict_until(self, n_free: int) -> None:
        """Shrink the cache until the pool has ``n_free`` blocks (or the
        cache is empty) — swap-outs take priority over cached prefixes."""
        while self.pool.n_free < n_free and self.entries:
            self._evict_lru()

    def put(self, h: int, tokens: Sequence[int],
            data: Dict[str, dict]) -> bool:
        """Demote one page under hash ``h``; LRU-evicts to make room.
        False only when the pool cannot hold even one block (all of it is
        pinned by swap records)."""
        if h in self.entries:
            self.entries.move_to_end(h)
            return True
        blocks = self.pool.alloc(1)
        while blocks is None and self.entries:
            self._evict_lru()
            blocks = self.pool.alloc(1)
        if blocks is None:
            self._bump("rejected")
            return False
        self.pool.store(blocks, data)
        self.entries[h] = _CacheEntry(blocks[0], tuple(int(t)
                                                       for t in tokens))
        self._bump("demotions")
        return True

    def match_chain(self, hashes: Sequence[int], seq: np.ndarray,
                    start: int, block_size: int,
                    peek: bool = False) -> List[int]:
        """Longest run of cached host blocks continuing the chain.

        ``hashes`` are the request's chained block hashes from position
        ``start`` on (the device match covered ``[0, start)``); each hit
        must also match the stored token content of the demoted block.
        Returns the host block ids in natural order; hits refresh LRU.
        ``peek=True`` is a side-effect-free probe (no LRU refresh, no hit
        counting) — used by the ``auto`` preemption cost model."""
        out: List[int] = []
        for i, h in enumerate(hashes):
            ent = self.entries.get(h)
            lo = (start + i) * block_size
            want = tuple(int(t) for t in seq[lo:lo + block_size])
            if ent is None or ent.tokens != want:
                break
            if not peek:
                self.entries.move_to_end(h)
            out.append(ent.block)
        if not peek:
            self._bump("hits", len(out))
        return out
