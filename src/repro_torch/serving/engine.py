"""Tetris serving engine — real PyTorch execution driven by the event loop.

Extends the discrete-event Simulator with *chunk-granular* real execution:
every CDSP prefill chunk is its own event and runs at the time the
scheduler's plan says it runs (per-chunk SP sizes, queueing and mid-prefill
preemption/requeue all happen at chunk boundaries, like the paper's
fine-grained SP), KV hands off to decode instances through per-chunk
handshake transfers, and both prefill and decode keep KV in paged block
pools (serving/cache_manager) — pages all the way down.

**Prefill is direct-to-pages**: each CDSP chunk scatters its KV into the
engine's prefill page pool the moment it executes
(``PagedKVCache.write_chunk``), and the next chunk reads the cross-chunk
history straight back out of those pages (core/cdsp.pages_history_view ->
ops.paged_prefill_attention — the paged-prefill and flash-attention CUDA
kernels on the card, the gather version on the CPU).  Admission is a
page-granular copy of the non-shared pages into the decode instance's
pool — the dense per-request
``(B, L)`` KV tree that the old ``history_to_decode_caches`` admission
materialised (doubling peak memory exactly when long prompts landed) no
longer exists anywhere.

Decode is *natively paged*: the model's attention consumes the pools
through block tables (models/attention.py — the fused paged-decode CUDA
kernel on the card, the gather version on the CPU), so no dense
``(batch, max_seq)`` KV view is ever materialised.  Blocks are allocated **grow-on-demand**: admission
commits only the prefilled KV's pages, each decode tick extends
allocations as sequences cross page boundaries, and on pool exhaustion (or
when free blocks fall under ``preempt_watermark``) the engine preempts the
newest-arrival resident.  What preemption *does* is the ``preempt_policy``
knob (serving/kv_offload.py): **swap** parks the victim's pages in a
host-memory tier and swaps them back when the pool has room (resuming
token-for-token with zero recomputed FLOPs), **recompute** drops the
blocks and re-prefills the generated prefix through the normal CDSP
plan/requeue path (also token-for-token identical), and **auto** (default)
compares the modeled PCIe swap-in time against the modeled re-prefill time
per victim.  The host pool doubles as an LRU **second-tier prefix cache**:
hash-published blocks are demoted there when their last device reference
dies, and admissions whose chained hashes match promote the pages back —
prefix sharing survives eviction.

**Prefix sharing + copy-on-write** (``prefix_sharing=True``): admission
matches the longest prefix of the incoming tokens against resident
requests — hashed full blocks via BlockManager.match_prefix, plus the
trailing partial block when the new request is a strict prefix of a
resident — and commits those blocks by reference instead of copying
pages.  Any append into a block referenced by several requests first
splits it copy-on-write (``_grow_or_preempt``), so a divergent suffix can
never corrupt a sibling's KV, and releases only free blocks whose last
reference died.  Routing sees the reclaimed capacity through
``DecodeInstance.credit_shared``.

A DynamicRateController can be wired directly into the engine: arrivals and
chunk-boundary queue backlog feed its sliding windows, and the policy's
improvement rate — the gate on SP expansion — comes from the controller's
observed load rather than a fixed constant.

Per-chunk timing is exposed in ``chunk_log`` / ``Request.chunk_sched`` /
``Request.chunk_exec``, and decode preemptions in ``preempt_log``, so
benchmarks can compare executed against simulated TTFT/TBT and track
memory-pressure behaviour.  On CPU this serves reduced models end-to-end
(tests/test_torch_engine); under a mesh context (launch/mesh.py
``make_context(mesh, "serve_paged")``, tests/test_torch_sharded_engine)
the paged pools themselves go sequence-parallel: the prefill pool stripes
over ``ctx.sp_axis`` (chunks run ring attention and each shard's history
pages rotate through the ring — core/ring_attention.ring_paged_prefill)
and each decode pool stripes over ``ctx.kv_split_axis`` (split-KV paged
decode island, per-shard partial softmax + LSE merge —
core/ring_attention.sharded_paged_decode), with every page write/copy
staying on its position (serving/cache_manager).  The engine's decisions
are the same on a mesh: it only hands the model per-shard tables.
"""

from __future__ import annotations

import functools
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.cdsp import prefill_chunk_paged
from repro_torch.core.improvement_rate import DynamicRateController
from repro_torch.core.latency_model import (DecodeLatencyModel, HostOffloadModel,
                                      InterconnectModel)
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ExecContext, make_context
from repro_torch.models.transformer import forward
from repro_torch.serving.cache_manager import (BlockManager, PagedKVCache,
                                         block_hashes)
from repro_torch.serving.kv_fabric import KVFabric
from repro_torch.serving.kv_offload import (HostKVPool, HostPrefixCache,
                                      SwapManager, SwapRecord,
                                      choose_preempt_policy)
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.simulator import ClusterSpec, Policy, Simulator
from repro_torch.serving.telemetry import OpProfiler
from repro_torch.serving.transfer import TransferManager


def _tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@dataclass
class _PrefillState:
    """Running state of a chunk-granular prefill.

    Attention KV lives in the engine's prefill page pool (scattered per
    chunk); only the O(1)-in-sequence non-attention state — SSD states,
    conv windows, cross KV — rides here as the ``aux`` history tree."""
    off: int = 0                        # tokens prefilled so far
    aux: Optional[dict] = None          # non-attention cross-chunk state
    logits: Optional[torch.Tensor] = None  # last chunk's next-token logits


@dataclass
class _DecodeMeta:
    """Per-resident-request decode bookkeeping.

    ``blocks`` aliases the BlockManager's allocation list for the request,
    so grow-on-demand ``extend`` calls (and copy-on-write block swaps) are
    visible here without copying.  ``tokens`` records the token ids whose
    KV is resident — the content prefix-sharing admission matches against;
    ``shared_tokens`` is the capacity credit taken at admission (reversed
    on evict).  ``hashes`` carries the chained content hashes of the full
    blocks published so far, so a block filling during decode extends the
    chain in O(block_size) instead of rehashing the whole prefix."""
    row: int                            # batch row (stable while resident)
    cache_len: int                      # tokens resident in the paged pool
    last_token: int                     # next model input
    blocks: List[int] = field(default_factory=list)
    shared_tokens: int = 0              # prefix-sharing capacity credit
    tokens: List[int] = field(default_factory=list)
    hashes: List[int] = field(default_factory=list)


class PagedDecodeState:
    """Block-table KV decode state for one decode instance.

    Attention KV lives in a PagedKVCache pool addressed through the
    BlockManager's per-request block lists.  Each decode tick hands the
    pools plus the active batch's block table straight into the model —
    attention consumes the table natively (models/attention.py), scatters
    the new token's K/V into its page, and returns the updated pools,
    which ``absorb`` folds back.  No dense ``(batch, max_seq)`` KV view is
    built at any point.  Non-attention per-request state (SSD state, conv
    window, cross KV) is O(1) in sequence length and kept as small
    per-request trees, stacked per tick.
    """

    def __init__(self, cfg: ModelConfig, max_batch: int, max_seq: int,
                 block_size: int = 64, n_backends: int = 8,
                 bandwidth: float = 40e9,
                 ctx: Optional[ExecContext] = None):
        ctx = ctx if ctx is not None else make_context()
        assert max_seq % block_size == 0, (max_seq, block_size)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.block_size = block_size
        # split-KV sharded pool: stripe the block pool over the context's
        # decode KV axis (pool rounded up to a whole number of stripes)
        self.kv_shards = ctx.pool_shards("decode")
        total_blocks = max_batch * max_seq // block_size
        total_blocks = -(-total_blocks // self.kv_shards) * self.kv_shards
        # TP head sharding on top of the stripe (TP×SP): each device holds
        # only its KVH/tp head slice of the pages it owns
        head_axis = (ctx.pool_head_axis(cfg.n_kv_heads)
                     if self.kv_shards > 1 else None)
        self.kv = PagedKVCache(cfg, total_blocks, block_size,
                               dtype=cfg.dtype, kv_shards=self.kv_shards,
                               mesh=ctx.mesh if self.kv_shards > 1 else None,
                               shard_axis=ctx.pool_axis("decode"),
                               head_axis=head_axis, device=ctx.device)
        self.blocks = BlockManager(total_blocks=total_blocks,
                                   block_size=block_size,
                                   kv_shards=self.kv_shards,
                                   kv_head_shards=self.kv.kv_head_shards)
        self.slots: List[Optional[int]] = [None] * max_batch   # row -> rid
        self.meta: Dict[int, _DecodeMeta] = {}
        self.aux: Dict[int, dict] = {}     # rid -> non-attn cache tree (B=1)
        self.transfers = TransferManager(n_backends=n_backends,
                                         bandwidth=bandwidth)

    def free_slot(self) -> Optional[int]:
        """Lowest free batch row, or None when the instance is full."""
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    @property
    def batch_size(self) -> int:
        return sum(s is not None for s in self.slots)

    # ------------------------------------------------- admission / sharing
    def plan_share(self, seq: np.ndarray, hashes: List[int]) -> tuple:
        """Longest prefix of ``seq`` servable by already-resident blocks.

        ``hashes`` is ``block_hashes(seq, block_size)`` (computed once by
        the caller, who also registers it).  Full blocks match through
        their chained content hashes (BlockManager.match_prefix); when
        the tokens past the hashed chain are a prefix of a resident's
        tokens, the owner's *next* block is shared too — typically its
        partial tail, whose surplus tokens are masked by the sharer's
        cache length, and whose first divergent append splits it
        copy-on-write.  Returns ``(blocks, shared_tokens)`` with
        shared_tokens never exceeding the shared blocks' capacity (the
        router's capacity credit must match the blocks actually reused).
        """
        bs = self.block_size
        chain = self.blocks.match_prefix(hashes)
        if chain:
            # chained hashes are content-addressed but hash() is not
            # collision-proof: share only the prefix of the chain that a
            # resident actually holding those blocks confirms
            # token-for-token, never a chain nobody's tokens back up
            full = [int(t) for t in seq]
            best = 0
            for meta in self.meta.values():
                k = 0
                while (k < len(chain) and k < len(meta.blocks)
                       and meta.blocks[k] == chain[k]):
                    k += 1
                k = min(k, meta.cache_len // bs, len(seq) // bs)
                if k > best and meta.tokens[:k * bs] == full[:k * bs]:
                    best = k
            chain = chain[:best]
        m = len(chain)
        n = len(seq)
        if m * bs >= n:
            return chain, m * bs
        want = [int(t) for t in seq[m * bs:n]]
        for meta in self.meta.values():
            if (len(meta.blocks) > m and meta.blocks[:m] == chain
                    and meta.cache_len >= n
                    and meta.tokens[m * bs:n] == want):
                return chain + [meta.blocks[m]], min(n, (m + 1) * bs)
        return chain, m * bs

    def insert(self, row: int, rid: int, aux_history: Optional[dict],
               cache_len: int, last_token: int, blocks: List[int],
               shared_tokens: int, tokens: np.ndarray) -> None:
        """Admit a request whose attention KV already sits in the pool
        (pages copied from the prefill pool / shared with a sibling by the
        engine); keep its non-attention aux state and resident tokens."""
        self.slots[row] = rid
        self.meta[rid] = _DecodeMeta(row, cache_len, last_token, blocks,
                                     shared_tokens,
                                     [int(t) for t in tokens])
        aux = {}
        for i, spec in enumerate(self.cfg.pattern):
            src = (aux_history or {}).get(str(i), {})
            ent = {}
            if spec.mixer != "attn" and "self" in src:
                ent["self"] = src["self"]
            if "cross" in src:
                ent["cross"] = src["cross"]
            if ent:
                aux[str(i)] = ent
        self.aux[rid] = aux

    def evict(self, rid: int) -> _DecodeMeta:
        """Drop a request (finished or preempted): decrement its block
        references — only blocks with no surviving prefix-sharing sibling
        return to the free list — and hand the meta back for the engine's
        shared-capacity accounting."""
        m = self.meta.pop(rid)
        self.slots[m.row] = None
        self.aux.pop(rid, None)
        self.blocks.release(rid)
        return m

    # -------------------------------------------------------------- batch
    def block_table(self, active: List[int]):
        """(max_batch, max_blocks) physical page table sized to the longest
        *live allocation* (not max_seq); inactive rows point at the scratch
        page so their writes can never corrupt live data.  On a sharded
        pool the global striped ids are converted to the per-shard local
        tables (kv_shards, max_batch, npg_local) the split-KV decode
        island consumes — striped over the pool's LIVE width
        (``BlockManager.active_shards``) but always with the full physical
        row count (idle shards get all-scratch rows)."""
        from repro_torch.serving.cache_manager import shard_block_table
        maxb = max(len(self.meta[r].blocks) for r in active)
        bt = np.full((self.max_batch, maxb), self.kv.scratch_block, np.int32)
        for r in active:
            m = self.meta[r]
            bt[m.row, :len(m.blocks)] = m.blocks
        if self.kv_shards > 1:
            bt = shard_block_table(bt, self.blocks.active_shards,
                                   self.blocks.blocks_per_shard,
                                   n_slots=self.kv_shards)
        return torch.as_tensor(bt, device=self.kv.device)

    def build_caches(self, active: List[int], bt) -> dict:
        """Assemble the decode-step cache tree: attention layers get the
        physical pools plus the block table (broadcast over the layer-scan
        axis) — consumed natively, never gathered dense — and per-request
        aux rows are stacked for everything else."""
        caches = {}
        bt_b = None
        for i, spec in enumerate(self.cfg.pattern):
            key = str(i)
            ent = {}
            if spec.mixer == "attn":
                if bt_b is None:
                    bt_b = bt[None].expand(
                        (self.cfg.n_blocks,) + tuple(bt.shape))
                p = self.kv.pools[key]
                ent["self"] = {"k": p["k"], "v": p["v"], "block_table": bt_b}
            else:
                ent["self"] = self._stack_rows(active, key, "self")
            if any("cross" in self.aux[r].get(key, {}) for r in active):
                ent["cross"] = self._stack_rows(active, key, "cross")
            caches[key] = ent
        return caches

    def _stack_rows(self, active: List[int], key: str, part: str):
        by_row = {self.meta[r].row: self.aux[r][key][part] for r in active}
        template = _tree_map(torch.zeros_like, next(iter(by_row.values())))
        rows = [by_row.get(i, template) for i in range(self.max_batch)]
        return _tree_map(lambda *xs: torch.cat(xs, dim=1), *rows)

    def absorb(self, new_caches: dict, active: List[int]) -> None:
        """Fold one decode step's outputs back: adopt the updated pools
        (the model already scattered each new token's K/V into its page)
        and re-slice updated aux state per request."""
        self.kv.adopt(new_caches)
        for r in active:
            row = self.meta[r].row
            for key, ent in self.aux[r].items():
                if "self" in ent:
                    ent["self"] = _tree_map(
                        lambda a: a[:, row:row + 1],
                        new_caches[key]["self"])


class ServingEngine(Simulator):
    """Chunk-granular real-execution engine over the event-clock Simulator.

    Adds to the Simulator: real CDSP prefill chunk execution, per-chunk
    handshake transfers, natively-paged decode with grow-on-demand block
    allocation, and preemption — mid-prefill at chunk boundaries and
    decode-side on block exhaustion / under the free-block watermark.

    ``preempt_watermark`` (fraction of the block pool, default 0 = off)
    arms the automatic policy: whenever a decode tick would leave fewer
    than ``watermark * total_blocks`` free blocks, the newest-arrival
    resident is preempted *before* the pool is hard-exhausted; with the
    default 0 the engine still preempts, but only on actual exhaustion.
    Every decode preemption appends a record to ``preempt_log``
    (t/rid/instance/reason/free_blocks/generated).

    ``prefill_pool_blocks`` sizes the engine-wide prefill page pool that
    chunks write into (default: ``n_prefill * max_seq`` tokens' worth).
    Exhausting it is backpressure, not failure: the oldest page holder's
    chunks are delayed until pages free up and younger holders restart
    their prefill (``_prefill_backpressure``).  ``prefix_sharing=False``
    disables block reuse across requests (every admission copies all of
    its pages — the baseline the sharing tests compare against).

    **Host offload tier** (serving/kv_offload.py): ``preempt_policy``
    picks what a decode preemption does with the victim's KV —
    ``"recompute"`` drops and re-prefills it (the pre-offload behaviour),
    ``"swap"`` parks it in host memory and swaps it back when the pool
    has room, and ``"auto"`` (the default) compares the modeled PCIe
    swap-in time against the modeled re-prefill time per victim
    (``choose_preempt_policy``; ``offload_model`` supplies the PCIe
    term).  ``host_pool_blocks`` sizes the host tier (default: one decode
    instance's worth; 0 disables it, forcing recompute).  The host pool
    doubles as an LRU *second-tier prefix cache*: hash-published blocks
    whose last device reference dies are demoted instead of lost, and a
    later admission whose chained hashes match promotes the pages back
    (``swap_stats`` surfaces the counters).

    **Mixed prefill/decode steps** (Sarathi-style piggybacking):
    ``decode_hosts`` maps decode instances to the prefill instances they
    are colocated with (``None``, the default, keeps the pools fully
    disaggregated — no step ever fuses).  When a CDSP chunk executes on
    an instance group that hosts a colocated decode instance, that
    instance is busy for the chunk's step window: standalone decode
    ticks landing inside the window are *deferred* to its end
    (``DecodeInstance.deferred_ticks``) — the serialized baseline whose
    TBT degrades whenever a long prefill is in flight.  With
    ``piggyback=True`` (the default when colocated) the chunk's step
    instead executes a batch of decode ticks *inside* the window as one
    fused step: each piggybacked tick costs
    ``DecodeLatencyModel.piggyback_latency`` (the mixed-step term — the
    chunk's slack, not a full serialized tick), coalescing supersedes
    the instance's pending timeline tick exactly once, and
    ``decode_budget`` caps the piggybacked decode tokens per fused step
    (``None`` = the window is the only limit; a wired
    ``DynamicRateController`` additionally squeezes the budget under
    prefill backlog via ``decode_budget``).  Fused steps append to
    ``mixed_log`` and the per-instance piggyback/standalone gauges;
    scheduling-wise the chunk planner prices the expected piggyback
    overhead into Eq. (1) (``CDSPScheduler.piggyback_overhead``).
    Token streams are bit-identical to the non-colocated engine either
    way — greedy decode depends only on each request's own cache.
    """

    def __init__(self, cfg: ModelConfig, params: dict, spec: ClusterSpec,
                 policy: Policy, *, ctx: Optional[ExecContext] = None,
                 max_batch: int = 8, max_seq: int = 512,
                 block_size: int = 64,
                 decode_model: Optional[DecodeLatencyModel] = None,
                 rate_controller: Optional[DynamicRateController] = None,
                 preempt_watermark: float = 0.0,
                 prefill_pool_blocks: Optional[int] = None,
                 prefix_sharing: bool = True,
                 preempt_policy: str = "auto",
                 host_pool_blocks: Optional[int] = None,
                 offload_model: Optional[HostOffloadModel] = None,
                 fabric: Optional[str] = "auto",
                 interconnect: Optional[InterconnectModel] = None,
                 decode_hosts: Optional[Dict[int, tuple]] = None,
                 piggyback: bool = True,
                 decode_budget: Optional[int] = None,
                 profile_ops: bool = False):
        # the tracer is always on in the real engine — the preempt/
        # restripe/mixed log views below are backed by it
        super().__init__(spec, policy, decode_model, trace=True)
        assert spec.disaggregated, "real engine decode is disaggregated"
        if preempt_policy not in ("auto", "swap", "recompute"):
            raise ValueError(
                f"preempt_policy must be 'auto', 'swap' or 'recompute', "
                f"got {preempt_policy!r}")
        if fabric not in ("auto", "on", "off", None):
            raise ValueError(
                f"fabric must be 'auto', 'on', 'off' or None, "
                f"got {fabric!r}")
        # the card unless the caller hands a CPU context (the tests do)
        ctx = ctx if ctx is not None else make_context()
        self.cfg = cfg
        self.params = params
        self.ctx = ctx
        self.preempt_watermark = preempt_watermark
        self.prefix_sharing = prefix_sharing
        self.preempt_policy = preempt_policy
        self.prompts: Dict[int, np.ndarray] = {}
        self.outputs: Dict[int, List[int]] = {}
        self.chunk_log: Dict[int, List[dict]] = {}
        # optional profiling around the chunk forward and the page ops
        # (fused tick, chunk scatter, restripe all-to-all) -> named
        # op_wall_us/* histograms in the metrics registry
        self.profiler = OpProfiler(self.metrics, enabled=profile_ops,
                                   device=ctx.device)
        # sequence-parallel sharded pools: prefill stripes over sp_axis
        # (ring-paged history), decode over kv_split_axis (split-KV paged
        # decode).  Admission moves pages between the two pools with
        # device-local stripe-aligned copies, so active shard counts must
        # agree.
        n_sp = ctx.pool_shards("prefill")
        n_kv = ctx.pool_shards("decode")
        if n_sp > 1 and n_kv > 1 and n_sp != n_kv:
            raise ValueError(
                f"prefill pool shards ({n_sp} over sp_axis="
                f"{ctx.sp_axis!r}) and decode pool shards ({n_kv} over "
                f"kv_split_axis={ctx.kv_split_axis!r}) must match: "
                "admission hands striped pages between the pools "
                "device-locally.  Use equal-size axes (e.g. "
                "make_context(mesh, 'serve_paged')).")
        self.dstates = [PagedDecodeState(cfg, max_batch, max_seq, block_size,
                                         n_backends=spec.backends_per_decode,
                                         bandwidth=spec.transfer_bw, ctx=ctx)
                        for _ in range(spec.n_decode)]
        # engine-wide prefill page pool: chunks scatter their KV here as
        # they execute; admission copies the non-shared pages into the
        # decode instance's pool and releases these
        if prefill_pool_blocks is None:
            prefill_pool_blocks = max(
                1, spec.n_prefill * max_seq // block_size)
        prefill_pool_blocks = -(-prefill_pool_blocks // n_sp) * n_sp
        self.pkv = PagedKVCache(cfg, prefill_pool_blocks, block_size,
                                dtype=cfg.dtype, kv_shards=n_sp,
                                mesh=ctx.mesh if n_sp > 1 else None,
                                shard_axis=ctx.pool_axis("prefill"),
                                head_axis=(ctx.pool_head_axis(cfg.n_kv_heads)
                                           if n_sp > 1 else None),
                                device=ctx.device)
        self.pblocks = BlockManager(total_blocks=prefill_pool_blocks,
                                    block_size=block_size, kv_shards=n_sp,
                                    kv_head_shards=self.pkv.kv_head_shards)
        # cluster KV fabric (serving/kv_fabric.py): owns the host tier —
        # numpy mirror pool shared by swap records and the LRU second-tier
        # prefix cache — plus the registry of every decode instance's
        # block books, and the cross-instance behaviors (placed swap-in,
        # page borrow/lend, peer prefix promotion).  ``fabric="auto"``
        # turns those on exactly when there is more than one decode
        # instance; a single-instance engine (or fabric="off"/None)
        # degenerates to the instance-local paths bit-for-bit.  The
        # engine keeps host/host_cache/swap as aliases of the
        # fabric-owned objects so every established code path reads
        # unchanged.
        if host_pool_blocks is None:
            host_pool_blocks = max_batch * max_seq // block_size
        cross = (spec.n_decode > 1 if fabric == "auto" else fabric == "on")
        self.fabric = KVFabric(cfg, spec, block_size, host_pool_blocks,
                               offload_model=offload_model,
                               interconnect=interconnect,
                               cross_instance=cross)
        self.host = self.fabric.host
        self.host_cache = self.fabric.host_cache
        self.swap = self.fabric.swap
        for did, (d, inst) in enumerate(zip(self.dstates, self.decodes)):
            self.fabric.register_instance(did, d, inst)
        if self.swap is not None:
            for did, d in enumerate(self.dstates):
                d.blocks.demote_cb = functools.partial(
                    self._demote_blocks, did)
        elif preempt_policy == "swap":
            raise ValueError(
                "preempt_policy='swap' needs a host tier; set "
                "host_pool_blocks > 0")
        if self.fabric.cross_instance:
            # instances advertise block-level memory headroom to the
            # router: freeness ranking caps the token view at what the
            # striped pool can actually commit
            for d, inst in zip(self.dstates, self.decodes):
                inst.headroom_fn = (
                    lambda bm=d.blocks: bm.effective_free() * block_size)
        self._suppress_demote = False       # during swap-out evictions
        self._demote_gathers = 0            # batched device->host reads
        self._prefill: Dict[int, _PrefillState] = {}
        self._preempt_flags: set = set()          # mid-prefill
        self._decode_preempt_flags: set = set()   # decode, at next tick
        # recompute-preemption state: outputs to restore after re-prefill,
        # and the token sequence (prompt + generated prefix) to re-prefill
        self._resume: Dict[int, List[int]] = {}
        self._resume_seq: Dict[int, np.ndarray] = {}
        # elastic SP restripe (drain-free stripe-width resize of the paged
        # pools) + host-prefix-cache-aware planning state
        self._restripe_pending = False
        # decode ticks that passed while recompute-preempted requests were
        # off the batch (one count per stalled request per tick) — the
        # "stalled decode" cost a drain-style resize pays and a live
        # restripe avoids.  A rid stalls from its eviction until it
        # rejoins a decode batch, which is later than its re-prefill
        # chunk executing: the handshake transfer and row admission sit
        # in between
        self.stall_ticks = 0
        self._stalled: set = set()
        self._host_skip: Dict[int, int] = {}  # rid -> planned prefix skip
        self.planner_promotions = 0           # host pages promoted by skips
        # mixed prefill/decode steps: decode instance -> colocated prefill
        # instances.  _busy_until marks each colocated instance's current
        # chunk-step window; _next_tick records the LAST pushed decode_tick
        # time per instance (last-write-wins coalescing: an event that pops
        # earlier than the record was superseded by a fused step and is
        # dropped — exactly once, since every push moves the record
        # forward); _fused_tick marks the instance whose tick is currently
        # executing inline inside a chunk step, which switches its pricing
        # to the mixed-step term.
        self._decode_hosts: Dict[int, frozenset] = {
            int(d): frozenset(int(i) for i in hosts)
            for d, hosts in (decode_hosts or {}).items()}
        self.piggyback = piggyback
        self.decode_budget = decode_budget
        self._busy_until: Dict[int, float] = {}
        self._next_tick: Dict[int, float] = {}
        self._fused_tick: Optional[int] = None
        self.controller = rate_controller
        # wire the block pools, transfer managers and host tier into the
        # metrics registry: per-shard free-block gauges and PCIe byte
        # counters update at the same call sites the books do
        self.pblocks.bind_metrics(self.metrics, "prefill/")
        for did, d in enumerate(self.dstates):
            d.blocks.bind_metrics(self.metrics, f"decode{did}/")
            d.transfers.bind_metrics(self.metrics, f"decode{did}/")
        if self.host_cache is not None:
            self.host_cache.bind_metrics(self.metrics, "host_cache/")
        if self.fabric.cross_instance:
            # fabric counters registered only when the cluster behaviors
            # are live: single-instance metric snapshots stay identical
            self.fabric.bind_metrics(self.metrics, "fabric/")
        if rate_controller is not None:
            own = getattr(policy, "controller", None)
            if own is not None and own is not rate_controller:
                raise ValueError(
                    "policy already owns a different DynamicRateController; "
                    "pass rate_controller=policy.controller or drop one")
            # SP expansion regulated by the controller's observed load
            # instead of the policy's static rate_fn
            policy.rate_fn = rate_controller.rate

    # ---------------------------------------------------------------- api
    def submit(self, req: Request, prompt_tokens: np.ndarray) -> None:
        """Enqueue a request for service.  Rejects requests whose worst-case
        cache (prompt + output) exceeds the decode block pool — those could
        never be admitted and would spin in the transfer retry loop."""
        d = self.dstates[0]
        cap = d.blocks.total_blocks * d.block_size
        if req.prompt_len + req.output_len > cap:
            raise ValueError(
                f"request {req.rid} needs {req.prompt_len + req.output_len} "
                f"cache tokens > decode pool capacity {cap} "
                f"(max_batch * max_seq)")
        pcap = self.pblocks.total_blocks * self.pblocks.block_size
        if req.prompt_len + req.output_len - 1 > pcap:
            # worst case: a decode preemption re-prefills prompt + all but
            # the last generated token through the prefill page pool
            raise ValueError(
                f"request {req.rid} may need "
                f"{req.prompt_len + req.output_len - 1} prefill pool "
                f"tokens > prefill pool capacity {pcap}; raise "
                f"prefill_pool_blocks")
        self.prompts[req.rid] = np.asarray(prompt_tokens)
        self.reqs[req.rid] = req
        self._push(req.arrival, "arrive", req.rid)

    def serve(self) -> Dict[int, List[int]]:
        """Drain the event heap; returns rid -> generated tokens."""
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            getattr(self, f"_on_{kind}")(t, payload)
        return self.outputs

    def _push(self, t: float, kind: str, payload) -> None:
        # last-write-wins tick coalescing: remember the latest scheduled
        # tick per instance so a fused step can supersede pending timeline
        # ticks (the stale events drop when they pop — see _on_decode_tick)
        if kind == "decode_tick":
            self._next_tick[int(payload)] = t
        super()._push(t, kind, payload)

    def preempt(self, rid: int, at: Optional[float] = None) -> None:
        """Flag ``rid`` for preemption.

        QUEUED/PREFILL: at the next chunk boundary the remaining chunks are
        cancelled and the remainder of the prompt is re-planned (requeued)
        under the then-current load.  DECODE — or TRANSFER, honoured once
        the request has joined a decode batch: at the instance's next
        decode tick the request is evicted via the engine's
        ``preempt_policy`` — swapped to the host tier, or recompute-style
        (blocks released, generated prefix re-prefilled) — token-for-token
        identical after resume either way.  With ``at`` the flag is
        set by an event at that virtual time; without it the flag applies
        immediately (e.g. before serve()).  A SWAPPED request is already
        preempted — its KV sits on the host and its device footprint is
        zero — so flagging it is deliberately a no-op (re-flagging would
        only thrash the swap-in it is waiting on).  The engine also
        preempts automatically on block exhaustion / watermark — no
        manual call needed."""
        if at is not None:
            self._push(at, "preempt", rid)
            return
        req = self.reqs.get(rid)
        if req is None:
            return
        if req.phase in (Phase.QUEUED, Phase.PREFILL):
            self._preempt_flags.add(rid)
        elif req.phase in (Phase.TRANSFER, Phase.DECODE):
            self._decode_preempt_flags.add(rid)

    # ------------------------------------------------- chunk-granular prefill
    def _prefill_seq(self, rid: int) -> np.ndarray:
        """Token sequence the current prefill runs over: the prompt, or —
        after a decode preemption — prompt + already-generated prefix."""
        return self._resume_seq.get(rid, self.prompts[rid])

    def _host_prefix_skip(self, rid: int) -> int:
        """Prompt-prefix tokens the two-tier prefix cache can serve
        without prefilling them (side-effect-free peek): whole cached
        blocks, capped so at least one token always runs through the
        prefill (the final chunk's logits seed decode).  The planner
        prices the remainder as chunks over this much pre-existing
        history and the first chunk start promotes the pages
        (``_promote_host_prefix``).  With the cluster fabric, the chain
        continues past the host-cache run across *peer* device pools —
        cost-gated (``_peer_copy_wins``): peer pages copy over the
        interconnect only when that beats re-prefilling them."""
        if self.host_cache is None or not self.prefix_sharing:
            return 0
        seq = np.asarray(self._prefill_seq(rid))
        bs = self.pblocks.block_size
        hashes = block_hashes(seq, bs)
        hits = self.host_cache.match_chain(hashes, seq, 0, bs, peek=True)
        n = len(hits)
        if self.fabric.cross_instance:
            _, peer = self.fabric.match_peer_chain(None, hashes[n:], seq, n)
            if peer and self._peer_copy_wins(len(peer)):
                n += len(peer)
        cap = (len(seq) - 1) // bs
        return min(n, cap) * bs

    def _peer_copy_wins(self, n_blocks: int) -> bool:
        """``choose_preempt_policy``-style cost gate for peer prefix
        promotion: copy ``n_blocks`` pages across the interconnect only
        when the modeled transfer undercuts the modeled prefill (Eq. 1,
        best SP) of the tokens they cover — otherwise recompute is
        cheaper and the chain ends at the host run."""
        L = max(n_blocks * self.pblocks.block_size, 1)
        rec_s = self.policy.model.latency(
            self.policy.model.optimal_sp(L), 0.0, L)
        return self.fabric.peer_copy_cost(n_blocks) < rec_s

    def _on_arrive(self, now: float, rid: int) -> None:
        self._price_piggyback(now)
        # engine-level controller observes arrivals unless the policy owns
        # the same controller (DynamicTetrisPolicy observes via on_arrival)
        if (self.controller is not None
                and getattr(self.policy, "controller", None)
                is not self.controller):
            self.controller.observe(now)
        skip = self._host_prefix_skip(rid)
        if skip:
            # host-cache-aware plan: only the uncached remainder is
            # chunked; the cached prefix rides in as promoted pages
            req = self.reqs[rid]
            self.tracer.record(now, "arrive", rid=rid,
                               track=("request", rid), host_skip=skip)
            self.policy.on_arrival(now)
            shadow = Request(rid=rid, arrival=now,
                             prompt_len=req.prompt_len - skip,
                             output_len=req.output_len, cached_tokens=skip)
            alloc = self.policy.plan(shadow, self._pool_view(now), now)
            if alloc is None:
                self.rejected.append(rid)
                self.tracer.record(now, "reject", rid=rid,
                                   track=("request", rid))
                return
            self._host_skip[rid] = skip
            self._prefill[rid] = _PrefillState()
            self._commit_plan(now, req, alloc)
            return
        super()._on_arrive(now, rid)
        if self.reqs[rid].chunk_plan is not None:
            self._prefill[rid] = _PrefillState()

    def _positions(self, off: int, L: int) -> torch.Tensor:
        pos = torch.arange(off, off + L, dtype=torch.int32,
                           device=self.ctx.device)
        if self.cfg.rope_type == "mrope":
            return pos[None, None].expand(3, 1, L)
        return pos[None]

    def _on_chunk_start(self, now: float, payload) -> None:
        rid, ci, gen = payload
        if gen != self.plan_gen.get(rid):
            return                          # superseded by a requeue
        if rid in self._preempt_flags:
            # preempted at the chunk boundary: this chunk and everything
            # after it are cancelled and re-planned under current load
            self._preempt_flags.discard(rid)
            self._requeue(now, rid)
            return
        req, st = self.reqs[rid], self._prefill[rid]
        seq = self._prefill_seq(rid)
        L, sp = req.chunk_plan[ci]
        if ci != len(req.chunk_exec):
            # an earlier chunk of this request is itself waiting on the
            # prefill pool: keep chunk order, try again shortly
            self._push(now + 0.05, "chunk_start", payload)
            return
        skip = self._host_skip.pop(rid, None)
        if skip and not self._promote_host_prefix(now, rid, skip, payload):
            return
        # prefill-direct-to-pages: grow this request's prefill-pool
        # allocation to cover the chunk, run the chunk against the paged
        # cross-chunk history, and scatter its KV into the pages — no
        # dense per-request KV tree is ever built
        self.pblocks.open(rid)
        if not self.pblocks.extend(rid, st.off + L):
            self._prefill_backpressure(now, rid, payload)
            return
        super()._on_chunk_start(now, payload)
        toks = torch.as_tensor(np.asarray(seq[None, st.off:st.off + L]),
                               device=self.ctx.device)
        pos = self._positions(st.off, L)
        alloc = self.pblocks.allocs[rid]
        hist_bt = alloc[:self.pblocks.blocks_for(st.off)]
        with self.profiler.op("prefill_chunk"):
            st.logits, new_caches, st.aux = prefill_chunk_paged(
                self.params, self.cfg, self.ctx, toks, pos,
                self.pkv.pools, hist_bt, st.off, st.aux)
        with self.profiler.op("scatter_chunk"):
            self.pkv.write_chunk(alloc, new_caches, pos,
                                 active=self.pblocks.active_shards)
        st.off += L
        self.chunk_log.setdefault(rid, []).append({
            "chunk": ci, "len": L, "sp": sp,
            "sched_start": req.chunk_sched[ci][0],
            "sched_end": req.chunk_sched[ci][1], "exec_start": now})
        if self.controller is not None:
            pool = self._pool_view(now)
            self.controller.observe_queue(
                now, sum(pool.values()) / max(len(pool), 1))
            self._maybe_restripe(now)
        self._run_piggyback(now, rid, ci)
        if st.off >= len(seq):
            self._preempt_flags.discard(rid)   # nothing left to preempt
            prior = self._resume.pop(rid, None)
            if prior is not None:
                # recompute resume: greedy decoding is deterministic, so
                # the re-prefill regenerates the same prefix — restore the
                # already-emitted tokens rather than re-emitting them
                self.outputs[rid] = prior
            else:
                self.outputs[rid] = [int(torch.argmax(
                    st.logits[0, 0, :self.cfg.vocab_size]))]
            self._resume_seq.pop(rid, None)

    def _prefill_backpressure(self, now: float, rid: int, payload) -> None:
        """Prefill page pool exhausted: apply backpressure, never crash.

        The oldest-arrival page holder keeps retrying in place — decode
        progress drains parked admissions, which release prefill pages —
        while younger holders release their pages and restart their
        prefill from scratch, breaking hold-and-wait so the oldest can
        always finish (its worst case is pool-bounded by submit())."""
        holders = [r for r in self._prefill if self.pblocks.allocs.get(r)]
        oldest = min(holders, key=lambda r: (self.reqs[r].arrival, r),
                     default=rid)
        if rid != oldest and self.pblocks.allocs.get(rid):
            self._restart_prefill(now, rid)
        else:
            self._push(now + 0.05, "chunk_start", payload)

    def _restart_prefill(self, now: float, rid: int) -> None:
        """Release ``rid``'s prefill pages and re-plan its prefill from
        scratch under the then-current load (it lost the prefill pool to
        an older request).  In-flight chunk/prefill events die via the
        plan-generation bump; greedy determinism keeps the restarted run
        token-identical."""
        req = self.reqs[rid]
        self.pblocks.release(rid)
        self._host_skip.pop(rid, None)
        self.plan_gen[rid] = self.plan_gen.get(rid, 0) + 1
        self._cancel_bookings(now, rid, 0)
        req.chunk_plan = []
        req.chunk_sched = []
        req.chunk_exec = []
        req.chunk_groups = []
        self.chunk_log.pop(rid, None)
        req.preemptions += 1
        req.phase = Phase.QUEUED
        self._prefill[rid] = _PrefillState()
        self.tracer.record(now, "requeue", rid=rid, track=("request", rid),
                           reason="restart")
        self._push(now + 0.05, "requeue", rid)

    def _promote_host_prefix(self, now: float, rid: int, skip: int,
                             payload) -> bool:
        """First chunk of a host-cache-aware plan: pull the cached prefix
        pages into the prefill pool and start the prefill at ``skip``.
        Returns False when the chunk must not run now — prefill-pool
        backpressure (the skip is re-armed and the chunk retried), or the
        cache entries were evicted between planning and execution (the
        plan is dropped and the request re-planned under what the cache
        holds NOW; greedy determinism keeps the output token-identical)."""
        st = self._prefill[rid]
        seq = self._prefill_seq(rid)
        bs = self.pblocks.block_size
        hashes = block_hashes(np.asarray(seq[:skip]), bs)
        promo = self.host_cache.match_chain(hashes, seq, 0, bs)
        peer_did, peer = None, []
        if len(promo) * bs < skip and self.fabric.cross_instance:
            # the planned skip ran past the host tier into a peer pool:
            # re-match the peer continuation (it may have been evicted
            # since planning, like the host entries)
            peer_did, peer = self.fabric.match_peer_chain(
                None, hashes[len(promo):], seq, len(promo))
            peer = peer[:skip // bs - len(promo)]
        if (len(promo) + len(peer)) * bs < skip:
            self._restart_prefill(now, rid)
            return False
        self.pblocks.open(rid)
        if not self.pblocks.extend(rid, skip):
            self._host_skip[rid] = skip
            self._prefill_backpressure(now, rid, payload)
            return False
        blocks = self.pblocks.allocs[rid]
        promo = promo[:len(blocks)]
        self.pkv.copy_from(self.host, promo, blocks[:len(promo)])
        if peer:
            # peer-resident continuation: one batched gather out of the
            # peer's pool, scattered into the prefill pages through the
            # same positional copy path host promotions use
            src = self.fabric.peer_pages(peer_did, peer)
            self.pkv.copy_from(src, range(len(peer)),
                               blocks[len(promo):len(promo) + len(peer)])
            self.fabric.note_peer_promotion(
                peer_did, self.dstates[peer_did].transfers, len(peer))
        self.planner_promotions += len(blocks)
        st.off = skip
        return True

    # ------------------------------------------------- elastic SP restripe
    def _pool_pairs(self):
        return [(self.pblocks, self.pkv)] + [(d.blocks, d.kv)
                                             for d in self.dstates]

    def request_restripe(self, n: int, at: Optional[float] = None) -> None:
        """Schedule a live stripe-width change of every paged pool to
        ``n`` active shards (clamped per pool to its physical width).
        The resize is drain-free: prefill chunks and decode ticks keep
        running across it — only the pages whose owning shard changes
        under the new ``i % n`` stripe invariant migrate, in one
        all-to-all per pool (BlockManager.restripe ->
        PagedKVCache.restripe).  When a pool lacks the free room to
        receive its migrations, newest-arrival holders are preempted
        (``reason="restripe"``) until it fits; with ``at=None`` the
        resize fires before any other event."""
        self._restripe_pending = True
        self._push(0.0 if at is None else at, "restripe", int(n))

    def _maybe_restripe(self, now: float) -> None:
        """Consume the controller's SP decision at a chunk boundary: on
        physically sharded pools a changed target stripe width schedules
        a live restripe.  Single-device engines (physical width 1) ignore
        decisions entirely — they ARE the fixed-SP oracle the distributed
        tests compare against."""
        phys = max([self.pblocks.kv_shards]
                   + [d.blocks.kv_shards for d in self.dstates])
        if phys <= 1 or self._restripe_pending:
            return
        cur = min(self.ctx.active_pool_shards or phys, phys)
        cands = [c for c in self.spec.sp_candidates if 1 <= c <= phys]
        tgt = self.controller.sp_decision(now, cands, cur)
        if tgt != cur:
            self.request_restripe(tgt, at=now)

    def _restripe_room(self, now: float, n: int) -> bool:
        """Make room for the restripe's cross-shard migrations: prefill-
        pool holders restart youngest-first (their requeue re-plans the
        same tokens), decode residents fall via the normal preemption
        policy after in-flight swap-in reservations are reclaimed.
        Returns False when some pool still cannot take its migrations
        (the caller retries the whole resize shortly)."""
        eff_p = min(n, self.pblocks.kv_shards)
        while not self.pblocks.can_restripe(eff_p):
            holders = [r for r in self._prefill
                       if self.pblocks.allocs.get(r)]
            if not holders:
                break
            self._restart_prefill(
                now, max(holders, key=lambda r: (self.reqs[r].arrival, r)))
        for did, d in enumerate(self.dstates):
            eff = min(n, d.blocks.kv_shards)
            while not d.blocks.can_restripe(eff):
                if self._cancel_pending_swap_ins(did):
                    continue
                resident = [r for r in d.slots
                            if r is not None and r in d.meta]
                if not resident:
                    break
                victim = max(resident,
                             key=lambda r: (self.reqs[r].arrival, r))
                self._preempt_decode(now, victim, reason="restripe")
        return (self.pblocks.can_restripe(eff_p)
                and all(d.blocks.can_restripe(min(n, d.blocks.kv_shards))
                        for d in self.dstates))

    def _on_restripe(self, now: float, n: int) -> None:
        if not self._restripe_room(now, n):
            self._push(now + 0.05, "restripe", n)
            return
        old = min(self.ctx.active_pool_shards
                  or max(bm.kv_shards for bm, _ in self._pool_pairs()),
                  max(bm.kv_shards for bm, _ in self._pool_pairs()))
        migrated = 0
        for bm, kv in self._pool_pairs():
            pairs = bm.restripe(min(n, bm.kv_shards))
            with self.profiler.op("restripe_all_to_all"):
                kv.restripe(pairs)
            migrated += len(pairs)
        self.ctx = self.ctx.with_(active_pool_shards=n)
        self.tracer.record(now, "restripe",
                           entry={"t": now, "n_old": old, "n_new": n,
                                  "migrated_blocks": migrated})
        self._restripe_pending = False

    def _on_prefill_done(self, now: float, payload) -> None:
        rid, gen = payload
        st = self._prefill.get(rid)
        if (gen == self.plan_gen.get(rid) and st is not None
                and st.off < len(self._prefill_seq(rid))):
            # chunks were delayed by prefill-pool backpressure: the KV is
            # not complete yet, so routing/transfer must wait for it
            self._push(now + 0.05, "prefill_done", payload)
            return
        super()._on_prefill_done(now, payload)

    def _on_preempt(self, now: float, rid: int) -> None:
        req = self.reqs.get(rid)
        if req is None:
            return
        if (req.phase == Phase.PREFILL and rid in self._prefill
                and self._prefill[rid].off < len(self._prefill_seq(rid))):
            self._preempt_flags.add(rid)
        elif req.phase in (Phase.TRANSFER, Phase.DECODE):
            self._decode_preempt_flags.add(rid)

    def _on_requeue(self, now: float, rid: int) -> None:
        self._requeue(now, rid, first=False)

    def _requeue(self, now: float, rid: int, first: bool = True) -> None:
        """Re-plan the unprefilled remainder of ``rid`` under current load
        (executed chunks and their history are kept)."""
        req, st = self.reqs[rid], self._prefill[rid]
        if first:
            req.preemptions += 1
            self.tracer.record(now, "requeue", rid=rid,
                               track=("request", rid),
                               reason="chunk_boundary")
            # cancel the old plan NOW — before attempting the re-plan — so
            # its un-executed chunk/prefill events can never fire while we
            # wait for the pool, and its reservations stop inflating queues
            self.plan_gen[rid] = self.plan_gen.get(rid, 0) + 1
            executed = len(req.chunk_exec)
            req.chunk_plan = req.chunk_plan[:executed]
            req.chunk_sched = req.chunk_sched[:executed]
            req.chunk_groups = req.chunk_groups[:executed]
            self._cancel_bookings(now, rid, executed)
        remaining = len(self._prefill_seq(rid)) - st.off
        # a fresh prefill (nothing executed yet) can start mid-prompt past
        # chunks whose prefix the host cache holds, exactly like arrival
        self._host_skip.pop(rid, None)
        skip = self._host_prefix_skip(rid) if st.off == 0 else 0
        shadow = Request(rid=rid, arrival=now, prompt_len=remaining - skip,
                         output_len=req.output_len, cached_tokens=skip)
        self._price_piggyback(now)
        alloc = self.policy.plan(shadow, self._pool_view(now), now)
        if alloc is None:
            self._push(now + 0.05, "requeue", rid)   # queue until it fits
            return
        if skip:
            self._host_skip[rid] = skip
        self._commit_plan(now, req, alloc)

    # ------------------------------------------------- transfer + routing
    def _start_transfer(self, now, d, req) -> None:
        """Per-chunk handshake transfer: each chunk is announced and lands
        as its own event; decode starts once every chunk has arrived.
        Wire sizes are the pages each chunk actually finalised in the
        prefill pool (paged handoff), not the dense-equivalent bytes."""
        dst = self.dstates[req.decode_instance]
        self._trace_transfer_start(now, req.rid)
        chunk_bytes = TransferManager.paged_chunk_bytes(
            [c for c, _ in req.chunk_plan], dst.block_size,
            self.spec.kv_bytes_per_token)
        dst.transfers.handshake(req.rid, len(chunk_bytes), chunk_bytes, now)
        t = now
        for k, b in enumerate(chunk_bytes):
            t += b / self.spec.transfer_bw
            self._push(t, "chunk_landed", (req.rid, k))

    def _on_chunk_landed(self, now: float, payload) -> None:
        rid, _k = payload
        d = self.dstates[self.reqs[rid].decode_instance]
        if d.transfers.chunk_landed(rid):
            self._on_transfer_done(now, rid)

    def _on_transfer_done(self, now: float, rid: int) -> None:
        req = self.reqs[rid]
        d = self.dstates[req.decode_instance]
        # grow-on-demand admission with prefix sharing: match the longest
        # resident prefix, then reserve only the tokens that need FRESH
        # blocks — decode growth is paid per tick, with preemption (not
        # over-reservation) covering exhaustion
        row = d.free_slot()
        if row is None:
            # no batch row: retry shortly without paying for the share
            # plan (hashing + per-resident token compares) on every poll
            self._push(now + 0.05, "transfer_done", rid)
            return
        resident = self._prefill[rid].off
        seq = np.asarray(self._prefill_seq(rid)[:resident])
        hashes = (block_hashes(seq, d.block_size) if self.prefix_sharing
                  else [])
        shared, shared_tok = (d.plan_share(seq, hashes)
                              if self.prefix_sharing else ([], 0))
        fresh = d.blocks.blocks_for(resident) - len(shared)
        if not d.blocks.reserve_virtual(rid, fresh * d.block_size,
                                        offset=len(shared)):
            # decode instance saturated: hold the backend, retry shortly
            # (a failed reserve leaves no virtual entry behind; the share
            # plan is recomputed from scratch on the retry)
            self._push(now + 0.05, "transfer_done", rid)
            return
        d.transfers.complete(rid)
        st = self._prefill.pop(rid)
        blocks = d.blocks.commit(rid, shared=shared)
        # second-tier prefix cache: past the device-resident match (full
        # blocks only — a shared partial tail ends the chain), continue
        # the hash chain through demoted host pages and promote the hits
        # back page-granularly instead of copying from the prefill pool
        promo: List[int] = []
        if (self.prefix_sharing and self.host_cache is not None
                and len(shared) * d.block_size == shared_tok):
            promo = self.host_cache.match_chain(
                hashes[len(shared):], seq, len(shared), d.block_size)
        # page-granular handoff: only the non-shared suffix pages move
        # from the prefill pool; the shared prefix is served in place by
        # the sibling's pages.  No dense per-request KV view exists.
        if promo:
            d.kv.copy_from(self.host, promo,
                           blocks[len(shared):len(shared) + len(promo)])
            d.transfers.note_swap("promote", TransferManager.swap_bytes(
                len(promo), d.block_size, self.spec.kv_bytes_per_token))
        skip = len(shared) + len(promo)
        src = self.pblocks.allocs[rid]
        d.kv.copy_from(self.pkv, src[skip:], blocks[skip:])
        if self.prefix_sharing:
            d.blocks.register_hashes(rid, hashes, tokens=seq)
        d.insert(row, rid, st.aux, resident, self.outputs[rid][-1],
                 blocks, shared_tok, seq)
        d.meta[rid].hashes = list(hashes)     # chain seed for decode growth
        self.pblocks.release(rid)
        self._stalled.discard(rid)            # back in a batch: stall over
        super()._on_transfer_done(now, rid)
        inst = self.decodes[req.decode_instance]
        if shared_tok:
            # routing must see the true free blocks: the shared prefix
            # consumed no new capacity
            inst.credit_shared(shared_tok)
        # resumed requests: the parent books a fresh prompt-sized join, but
        # the re-prefilled generated prefix is resident too — charge it and
        # drop it from the remaining-growth commitment
        if req.generated:
            inst.slots_free -= req.generated
            inst.virtual -= req.generated

    # --------------------------------------------------------- real decode
    def _watermark_blocks(self, d: PagedDecodeState) -> int:
        return int(np.ceil(self.preempt_watermark * d.blocks.total_blocks))

    def _host_cached_tokens(self, d: PagedDecodeState, rid: int) -> int:
        """Tokens of ``rid``'s resume sequence already held by the host
        prefix cache (chained-hash walk, no LRU/stat side effects) — the
        part of a recompute whose KV admission would promote instead of
        copying.  Used only to price the ``auto`` policy compare."""
        if self.host_cache is None or not self.prefix_sharing:
            return 0
        m = d.meta[rid]
        seq = np.asarray(m.tokens[:m.cache_len])
        hashes = block_hashes(seq, d.block_size)
        hits = self.host_cache.match_chain(hashes, seq, 0, d.block_size,
                                           peek=True)
        return len(hits) * d.block_size

    def _preempt_choice(self, d: PagedDecodeState, rid: int) -> tuple:
        """Resolve the preemption policy for one victim.

        Returns ``(policy, swap_in_ms, recompute_ms, resume_tokens)``:
        under ``auto`` the modeled PCIe swap-in time of the victim's
        resident pages is compared against the modeled re-prefill time of
        its resume sequence (kv_offload.choose_preempt_policy); explicit
        ``swap`` / ``recompute`` short-circuit the compare but still
        report both costs so ``preempt_log`` lets benchmarks audit the
        decision.  ``resume_tokens`` is the length the recompute cost was
        priced on — exactly what a recompute preemption re-prefills.
        Host-prefix-cache hits on the resume sequence discount the
        recompute estimate (their pages promote back over PCIe instead of
        being re-copied at admission), so ``auto`` stops over-preferring
        swap for victims whose prefix survived an earlier eviction."""
        req = self.reqs[rid]
        outs = self.outputs[rid]
        resume = req.prompt_len + (len(outs) - 1 if len(outs) > 1 else 0)
        if self.swap is None:
            return "recompute", float("inf"), 0.0, resume
        # the cache walk (O(cache_len) hashing) only matters when the
        # verdict is actually decided by the compare
        cached = (self._host_cached_tokens(d, rid)
                  if self.preempt_policy == "auto" else 0)
        # destination congestion (fabric engines only, keeping the
        # single-instance preempt_log byte-identical): a swap-in resumes
        # into a live batch, so its first token back also waits one tick
        # per already-resident request — without this term a swap into a
        # saturated instance beats recompute on paper while losing on
        # observed TTFT
        qd, qms = 0, 0.0
        if self.fabric.cross_instance:
            did = req.decode_instance
            qd = max(0, len(self.decodes[did].batch) - 1)
            qms = self._queue_tick_s(did) * 1e3
        policy, swap_ms, rec_ms = choose_preempt_policy(
            len(d.meta[rid].blocks), d.block_size,
            self.spec.kv_bytes_per_token, resume,
            self.policy.model, self.swap.model, cached_tokens=cached,
            queue_depth=qd, queue_ms=qms)
        if self.preempt_policy != "auto":
            policy = self.preempt_policy
        return policy, swap_ms, rec_ms, resume

    def _queue_tick_s(self, did: int) -> float:
        """Modeled seconds of one decode tick on instance ``did``'s
        current batch — the unit of the destination queue-depth term in
        swap-in placement and the ``auto`` policy compare."""
        inst = self.decodes[did]
        cache = sum(r.cache_tokens for r in inst.batch)
        return self.decode_model.latency(max(len(inst.batch), 1), cache,
                                         sp=1, tp=self.spec.tp_decode)

    def _preempt_decode(self, now: float, rid: int, reason: str) -> None:
        """Preempt a decode-resident request under memory pressure (or a
        manual flag), via the policy-chosen mechanism:

        * **swap**: the victim's pages move to the host tier and its
          decode state is parked (``_swap_out``); it swaps back in and
          resumes token-for-token once the pool has room — no prefill
          FLOPs are burnt.
        * **recompute**: release its blocks, leave the continuous batch,
          and requeue the full generated prefix (prompt + emitted tokens)
          through the normal CDSP plan path.  The emitted tokens are
          restored verbatim when the re-prefill completes (greedy
          decoding is deterministic), so generation is token-for-token
          identical to an unpreempted run — this is also the fallback
          when the host tier cannot hold the victim.

        Every event logs the chosen ``policy`` and both modeled costs
        (``swap_in_ms`` / ``recompute_ms``) so the ``auto`` decision is
        auditable."""
        req = self.reqs[rid]
        did = req.decode_instance
        d, inst = self.dstates[did], self.decodes[did]
        outs = self.outputs[rid]
        policy, swap_ms, rec_ms, resume = self._preempt_choice(d, rid)
        entry = {
            "t": now, "rid": rid, "instance": did, "reason": reason,
            "policy": policy, "swap_in_ms": swap_ms,
            "recompute_ms": rec_ms, "resume_tokens": 0,
            "free_blocks": d.blocks.n_free, "generated": len(outs),
            "chunks_discarded": 0}
        if policy == "swap":
            if self._swap_out(now, rid):
                self.tracer.record(now, "preempt", rid=rid,
                                   track=("request", rid), entry=entry)
                return
            # host tier full of pinned swap records: recompute fallback
            entry["policy"] = "recompute"
            self.swap.counters["fallback_recompute"] += 1
        entry["resume_tokens"] = resume
        entry["chunks_discarded"] = len(req.chunk_plan or [])
        self.tracer.end("decode_resident", rid, now)
        self.tracer.record(now, "preempt", rid=rid, track=("request", rid),
                           entry=entry)
        meta = d.evict(rid)
        if meta.shared_tokens:
            inst.debit_shared(meta.shared_tokens)
        # the evicted KV is gone — the executed chunk history goes with it,
        # so the resume plan (and its handshake transfer) covers exactly
        # the re-prefilled chunks, not the discarded first-stint ones
        req.chunk_plan = []
        req.chunk_sched = []
        req.chunk_exec = []
        req.chunk_groups = []
        self.chunk_log.pop(rid, None)
        for r in inst.batch:
            if r.rid == rid:
                inst.batch.remove(r)
                break
        # parent grow-on-demand accounting: resident tokens come back, the
        # not-yet-generated growth commitment is dropped
        inst.slots_free += req.prompt_len + req.generated
        inst.virtual -= req.output_len - req.generated
        req.preemptions += 1
        req.phase = Phase.QUEUED
        req.decode_instance = None
        base = np.asarray(self.prompts[rid])
        self._resume[rid] = list(outs)
        self._stalled.add(rid)
        self._resume_seq[rid] = (
            np.concatenate([base, np.asarray(outs[:-1], base.dtype)])
            if len(outs) > 1 else base.copy())
        self._prefill[rid] = _PrefillState()
        self._push(now, "requeue", rid)

    # ----------------------------------------------------- host swap tier
    def _demote_blocks(self, did: int, dying: List[tuple]) -> None:
        """BlockManager demote hook: hash-published blocks whose last
        device reference died in one release — copy their pages into the
        host prefix cache before any of them can be reallocated, so the
        prefixes stay matchable.  All pages move in a SINGLE batched
        device->host gather (one PCIe read per release, not one per
        block: a finishing 128K context used to pay hundreds of tiny
        staging reads here).  Suppressed during swap-out evictions (the
        SwapManager already holds the victim's full copy and will restore
        + republish it)."""
        if self.host_cache is None or self._suppress_demote:
            return
        fresh: List[tuple] = []
        for b, h, tokens in dying:
            if h in self.host_cache.entries:
                self.host_cache.put(h, tokens, {})    # LRU refresh, no copy
            else:
                fresh.append((b, h, tokens))
        if not fresh:
            return
        if self.host.n_free == 0 and not self.host_cache.entries:
            # pool fully pinned by swap records: the puts below could only
            # reject — skip the device->host page gather entirely
            self.host_cache.stats["rejected"] += len(fresh)
            return
        d = self.dstates[did]
        pages = d.kv.read_blocks([b for b, _, _ in fresh])
        self._demote_gathers += 1
        stored = 0
        for j, (b, h, tokens) in enumerate(fresh):
            data = {layer: {part: arr[:, j:j + 1]
                            for part, arr in parts.items()}
                    for layer, parts in pages.items()}
            if self.host_cache.put(h, tokens, data):
                stored += 1
        if stored:
            d.transfers.note_swap("demote", TransferManager.swap_bytes(
                stored, d.block_size, self.spec.kv_bytes_per_token))

    def _swap_out(self, now: float, rid: int) -> bool:
        """Move a victim's resident KV pages to the host tier and park its
        decode state (kv_offload.SwapRecord).  False when the host pool
        cannot hold the pages even after shrinking the prefix cache (the
        caller falls back to recompute).  The PCIe write is an event: the
        swap completes at ``now + swap_time`` while decode ticks keep
        running — transfers overlap compute on the event clock."""
        req = self.reqs[rid]
        did = req.decode_instance
        d, inst = self.dstates[did], self.decodes[did]
        m = d.meta[rid]
        n = len(m.blocks)
        if self.host.n_free + len(self.host_cache) < n:
            return False       # eviction could never free enough: don't
        #                        wipe the prefix cache for a doomed swap
        hblocks = self.host.alloc(n)
        if hblocks is None:
            self.host_cache.evict_until(n)   # swap beats cached prefixes
            hblocks = self.host.alloc(n)
        assert hblocks is not None, "host pool accounting violated"
        self.host.store(hblocks, d.kv.read_blocks(m.blocks))
        aux = d.aux.get(rid)
        self._suppress_demote = True
        try:
            meta = d.evict(rid)
        finally:
            self._suppress_demote = False
        if meta.shared_tokens:
            inst.debit_shared(meta.shared_tokens)
        for r in inst.batch:
            if r.rid == rid:
                inst.batch.remove(r)
                break
        inst.swap_out(req, meta.cache_len)
        req.preemptions += 1
        req.phase = Phase.SWAPPED
        self._decode_preempt_flags.discard(rid)
        self.swap.records[rid] = SwapRecord(
            rid=rid, did=did, host_blocks=hblocks,
            cache_len=meta.cache_len, last_token=meta.last_token,
            tokens=meta.tokens, aux=aux, origin_did=did)
        n_bytes = self.swap.block_bytes(n)
        self.swap.counters["swap_outs"] += 1
        self.fabric.note_swap_out(did)
        self.swap.counters["bytes_out"] += n_bytes
        d.transfers.note_swap("out", n_bytes)
        self.tracer.end("decode_resident", rid, now)
        self.tracer.begin("swap", rid, now, track=("request", rid))
        self.tracer.record(now, "swap_out", rid=rid,
                           track=("request", rid), blocks=n,
                           n_bytes=n_bytes)
        self._push(now + self.swap.model.swap_time(n_bytes),
                   "swap_out_done", rid)
        return True

    def _on_swap_out_done(self, now: float, rid: int) -> None:
        """The PCIe write retired; start trying to come back (capacity may
        already exist — e.g. the pressure came from a burst that drained)."""
        self._on_swap_in_try(now, rid)

    def _on_swap_in_try(self, now: float, rid: int) -> None:
        """Claim a batch row + a block reservation for a parked request;
        retries until the instance has room above the watermark.  The
        reservation (BlockManager.reserve_virtual) spans the PCIe flight,
        and resident growth honours it (``extend`` subtracts virtual
        blocks) — but may reclaim it via ``_cancel_pending_swap_ins`` when
        the pool tightens, sending this request back to retrying.

        **Placed swap-in** (cluster fabric): before claiming anything,
        the fabric scores every instance as a resume target — modeled
        PCIe + interconnect (off-origin) + destination queue depth — and
        the record migrates to the winner: the parked request resumes on
        a different instance token-for-token (greedy decode depends only
        on its own cache).  The origin's ``swapped_tokens`` gauge moves
        with it; start/done book their usual inverses on the new
        instance."""
        rec = self.swap.records[rid]
        req = self.reqs[rid]
        if self.fabric.cross_instance:
            tgt = self.fabric.best_resume_target(
                rec, self._watermark_blocks, self._queue_tick_s)
            if tgt is not None and tgt != rec.did:
                self.decodes[rec.did].swapped_tokens -= rec.cache_len
                self.decodes[tgt].swapped_tokens += rec.cache_len
                self.tracer.record(now, "swap_place", rid=rid,
                                   track=("request", rid),
                                   entry={"t": now, "rid": rid,
                                          "origin": rec.did,
                                          "target": tgt})
                rec.did = tgt
                req.decode_instance = tgt
        d, inst = self.dstates[rec.did], self.decodes[rec.did]
        need = d.blocks.blocks_for(rec.cache_len)
        # land only with watermark headroom to spare (capped at the pool:
        # an empty instance must always be able to take its request back)
        floor = min(need + self._watermark_blocks(d), d.blocks.total_blocks)
        row = d.free_slot()
        if (row is None
                or d.blocks.effective_free() < floor
                or not d.blocks.reserve_virtual(
                    rid, need * d.block_size)):
            self._push(now + 0.05, "swap_in_try", rid)
            return
        d.slots[row] = rid                  # claim the row (meta at landing)
        rec.row = row
        inst.swap_in_start(req, rec.cache_len)
        n_bytes = self.swap.block_bytes(len(rec.host_blocks))
        self.swap.counters["bytes_in"] += n_bytes
        d.transfers.note_swap("in", n_bytes)
        self.tracer.record(now, "swap_in_start", rid=rid,
                           track=("request", rid), n_bytes=n_bytes)
        self._push(now + self.swap.model.swap_time(n_bytes),
                   "swap_in_done", rid)

    def _on_swap_in_done(self, now: float, rid: int) -> None:
        """Swap-in landed: commit the reserved blocks, scatter the host
        pages back into the pool, rebuild the decode meta and rejoin the
        continuous batch — cache_len/last_token/outputs are exactly what
        they were at swap-out, so generation resumes token-for-token.

        **Swap-in re-sharing**: before committing, the same ``plan_share``
        pass admission runs matches the returning prefix against the
        residents — blocks a sibling still holds are committed *by
        reference* (the reservation shrinks to the fresh remainder and
        only the non-shared host pages are scattered back), so a swap
        round trip no longer duplicates a prefix that never left the
        device."""
        rec = self.swap.records[rid]
        if rec.row is None:
            # reservation was reclaimed by resident growth mid-flight
            self._on_swap_in_try(now, rid)
            return
        req = self.reqs[rid]
        d, inst = self.dstates[rec.did], self.decodes[rec.did]
        del self.swap.records[rid]
        seq = np.asarray(rec.tokens[:rec.cache_len])
        hashes = (block_hashes(seq, d.block_size) if self.prefix_sharing
                  else [])
        shared, shared_tok = (d.plan_share(seq, hashes)
                              if self.prefix_sharing else ([], 0))
        if shared:
            # shrink the reservation to the fresh remainder; the take over
            # a stripe-suffix of the reserved positions is always covered
            need = d.blocks.blocks_for(rec.cache_len) - len(shared)
            d.blocks.update_virtual(rid, need * d.block_size, len(shared))
            self.swap.counters["swap_in_shared_blocks"] += len(shared)
        blocks = d.blocks.commit(rid, shared=shared)
        d.kv.copy_from(self.host, rec.host_blocks[len(shared):],
                       blocks[len(shared):])
        self.host.free(rec.host_blocks)
        d.insert(rec.row, rid, rec.aux, rec.cache_len, rec.last_token,
                 blocks, shared_tok, rec.tokens)
        if self.prefix_sharing:
            # republish the full blocks so sharing (and demotability)
            # survive the round trip
            d.blocks.register_hashes(rid, hashes, tokens=rec.tokens)
            d.meta[rid].hashes = list(hashes)
        inst.swap_in_done(req, rec.cache_len)
        if shared_tok:
            inst.credit_shared(shared_tok)
        self.swap.counters["swap_ins"] += 1
        self.fabric.note_swap_in(rec)
        self.tracer.end("swap", rid, now)
        self.tracer.record(now, "swap_in_done", rid=rid,
                           track=("request", rid),
                           shared_blocks=len(shared))
        self.tracer.begin("decode_resident", rid, now,
                          track=("request", rid))
        req.phase = Phase.DECODE
        inst.batch.append(req)
        if not inst.ticking:
            inst.ticking = True
            self._push(now, "decode_tick", rec.did)

    def _cancel_pending_swap_ins(self, did: int) -> bool:
        """Reclaim the block reservation held by ONE in-flight swap-in of
        instance ``did`` so a resident can grow NOW; the swapped request
        drops back to the retry loop (its ``swap_in_done`` sees the
        cleared row).  One at a time: the caller re-checks after each
        reclaim, so other in-flight swap-ins keep their reservation (and
        avoid re-paying the PCIe transfer) when one was enough.  Returns
        True if anything was reclaimed."""
        if self.swap is None:
            return False
        d, inst = self.dstates[did], self.decodes[did]
        for rid, rec in self.swap.records.items():
            if rec.did == did and rec.row is not None:
                d.slots[rec.row] = None
                rec.row = None
                d.blocks.cancel_virtual(rid)
                inst.swap_in_cancel(self.reqs[rid], rec.cache_len)
                return True
        return False

    # --------------------------------------------- tracer-backed log views
    # The four ad-hoc logs predate the unified tracer.  Each preemption/
    # restripe/fused-step now records ONE tracer event carrying the legacy
    # dict verbatim, and these views rebuild the exact pre-telemetry lists
    # (same dicts, same order) so existing consumers are unchanged.
    @property
    def preempt_log(self) -> List[dict]:
        """Decode preemption records (see ``_preempt_decode``):
        t/rid/instance/reason/policy/swap_in_ms/recompute_ms/
        resume_tokens/free_blocks/generated/chunks_discarded."""
        return self.tracer.entries("preempt")

    @property
    def restripe_log(self) -> List[dict]:
        """Completed live restripes: t/n_old/n_new/migrated_blocks."""
        return self.tracer.entries("restripe")

    @property
    def mixed_log(self) -> List[dict]:
        """Fused mixed prefill/decode steps (``_run_piggyback``):
        t/rid/chunk/instance/ticks/tokens/window."""
        return self.tracer.entries("fused_step")

    @property
    def swap_stats(self) -> Dict[str, float]:
        """Host-offload tier counters: swap round trips and bytes, parked
        requests, recompute fallbacks, host pool occupancy, and the
        second-tier prefix cache's demotions/hits/evictions.  With the
        cluster fabric active (``n_decode > 1`` under ``fabric="auto"``,
        or ``fabric="on"``) two extra keys appear: ``"fabric"`` — the
        cluster-wide counters (placed vs pinned swap-ins, lease traffic,
        peer promotions, interconnect bytes) — and ``"per_instance"`` —
        the same activity broken down by decode instance id.  Neither
        key exists single-instance, keeping the dict byte-identical to
        the pre-fabric engine there."""
        out = {"swap_outs": 0, "swap_ins": 0, "bytes_out": 0.0,
               "bytes_in": 0.0, "fallback_recompute": 0, "swapped_now": 0,
               "swap_in_shared_blocks": 0, "demote_gathers": 0,
               "host_blocks_in_use": 0, "host_peak_blocks": 0,
               "demotions": 0, "host_prefix_hits": 0, "cache_evictions": 0,
               "planner_promotions": 0}
        if self.swap is None:
            if self.fabric.cross_instance:
                out["fabric"] = dict(self.fabric.counters)
                out["per_instance"] = {did: dict(st) for did, st
                                       in self.fabric.per_instance.items()}
            return out
        out.update(self.swap.counters)
        out["demote_gathers"] = self._demote_gathers
        out["planner_promotions"] = self.planner_promotions
        out["swapped_now"] = len(self.swap.records)
        out["host_blocks_in_use"] = (self.host.total_blocks
                                     - self.host.n_free)
        out["host_peak_blocks"] = self.host.peak_in_use
        out["demotions"] = self.host_cache.stats["demotions"]
        out["host_prefix_hits"] = self.host_cache.stats["hits"]
        out["cache_evictions"] = self.host_cache.stats["evictions"]
        if self.fabric.cross_instance:
            out["fabric"] = dict(self.fabric.counters)
            out["per_instance"] = {did: dict(st) for did, st
                                   in self.fabric.per_instance.items()}
        return out

    @property
    def mixed_stats(self) -> Dict[str, int]:
        """Mixed-step gauges summed over the decode instances: ticks and
        batch tokens executed piggybacked inside chunk-step windows vs as
        standalone timeline events, standalone ticks deferred to a busy
        window's end, and the number of fused steps logged."""
        out = {"piggyback_ticks": 0, "piggyback_tokens": 0,
               "standalone_ticks": 0, "standalone_tokens": 0,
               "deferred_ticks": 0, "fused_steps": len(self.mixed_log)}
        for inst in self.decodes:
            out["piggyback_ticks"] += inst.piggyback_ticks
            out["piggyback_tokens"] += inst.piggyback_tokens
            out["standalone_ticks"] += inst.standalone_ticks
            out["standalone_tokens"] += inst.standalone_tokens
            out["deferred_ticks"] += inst.deferred_ticks
        return out

    def _grow_or_preempt(self, now: float, did: int) -> None:
        """Before a decode step: honour manual decode-preempt flags, then
        make every resident's append target writable — extend allocations
        past page boundaries, and split copy-on-write any block this
        tick's token would land in that a prefix-sharing sibling still
        references.  Both need free blocks; growth is granted
        oldest-arrival first, and when it would exhaust the pool (or dip
        under the watermark while a victim exists) the newest-arrival
        resident is preempted — swap or recompute per the engine's
        ``preempt_policy`` — until the step fits.  Before any victim
        falls, block reservations held by in-flight swap-ins are
        reclaimed (the swapped request just retries later — cheaper than
        preempting anyone).  A lone resident may always grow — submit()
        bounds its worst case to the pool, it can need no CoW (nobody
        shares with it), and preempting it could never help."""
        d = self.dstates[did]
        bm = d.blocks
        fab = self.fabric if self.fabric.cross_instance else None
        for rid in [r for r in d.slots
                    if r is not None and r in d.meta
                    and r in self._decode_preempt_flags]:
            self._decode_preempt_flags.discard(rid)
            self._preempt_decode(now, rid, reason="manual")
        wm = self._watermark_blocks(d)
        if fab is not None and fab.credit(did):
            # borrower pressure subsided: once this instance clears its
            # own (uncredited) watermark with room to spare, hand the
            # leases back so donors regain their blocks
            fab.release_borrowed(did, max(0, bm.effective_free() - wm))
        order = sorted(d.meta, key=lambda r: (self.reqs[r].arrival, r))
        for rid in order:
            if rid not in d.meta:
                continue                   # became a victim this tick
            while True:
                m = d.meta[rid]
                grow = bm.grow_blocks_needed(rid, m.cache_len + 1)
                # this tick appends at position cache_len; a write into a
                # still-shared block must split it first (one fresh block)
                cow = (grow == 0 and m.cache_len % bm.block_size != 0
                       and bm.needs_cow(rid, m.cache_len // bm.block_size))
                need = grow or (1 if cow else 0)
                if need == 0:
                    break
                resident = [r for r in d.slots
                            if r is not None and r in d.meta]
                floor = wm if len(resident) > 1 else 0
                if fab is not None:
                    # borrowed leases credit the watermark floor: the
                    # headroom the watermark reserves now lives on the
                    # donor (physically off its free lists)
                    floor = max(0, floor - fab.credit(did))
                # growth sees only blocks not promised to an in-flight
                # swap-in; reclaim those reservations before anyone falls.
                # ``fits`` is the per-shard exact check — a striped pool
                # can exhaust the target shard while others still have
                # room; the watermark compare uses the per-shard-scaled
                # effective free count for the same reason
                eff = bm.effective_free()
                fits = (bm.can_take_at(m.cache_len // bm.block_size)
                        if cow else bm.can_extend(rid, m.cache_len + 1))
                if ((not fits or eff - need < floor)
                        and self._cancel_pending_swap_ins(did)):
                    continue
                if fab is not None and (not fits or eff - need < floor):
                    # cluster pressure valves, in escalation order: take
                    # back anything this instance lent out (lent headroom
                    # outranks preempting a resident here), then — when
                    # the shortfall is watermark-only, never physical
                    # exhaustion — borrow the missing floor from a donor
                    if fab.recall_from_donor(did):
                        continue
                    if fits and eff - need >= 0:
                        short = floor - (eff - need)
                        if short > 0 and fab.borrow(
                                did, short, self._watermark_blocks):
                            continue
                if len(resident) <= 1 or (fits and eff - need >= floor):
                    # a lone resident may dip below the watermark; its
                    # worst case is pool-bounded by submit(), so a failed
                    # extend here is an accounting bug, not a full pool
                    if cow:
                        src, dst = bm.ensure_writable(
                            rid, m.cache_len // bm.block_size)
                        d.kv.copy_within(src, dst)
                    else:
                        grew = bm.extend(rid, m.cache_len + 1)
                        assert grew, (rid, need, bm.n_free)
                    continue               # re-check (extend then CoW?)
                victim = max(resident,
                             key=lambda r: (self.reqs[r].arrival, r))
                self._preempt_decode(
                    now, victim,
                    reason=("exhaustion" if eff < need or not fits
                            else "watermark"))
                if victim == rid:
                    break

    # ------------------------------------------- mixed prefill/decode steps
    def _price_piggyback(self, now: float) -> None:
        """Before planning: price the expected piggyback overhead of one
        chunk step into the scheduler's Eq. (1) budget — the cost of one
        fused decode tick over the busiest colocated instance's current
        batch.  Zero when nothing is colocated (or piggybacking is off),
        which keeps non-colocated engines byte-identical to the planner's
        pure-prefill pricing."""
        sched = getattr(self.policy, "sched", None)
        if sched is None:
            return
        over = 0.0
        if self._decode_hosts and self.piggyback:
            for did in self._decode_hosts:
                inst = self.decodes[did]
                if inst.batch:
                    cache = sum(r.cache_tokens for r in inst.batch)
                    over = max(over, self.decode_model.piggyback_latency(
                        len(inst.batch), cache, tp=self.spec.tp_decode))
        sched.piggyback_overhead = over

    def _decode_budget_now(self, now: float) -> float:
        """Piggybacked decode tokens allowed per fused step right now —
        the configured ``decode_budget`` knob, squeezed by the controller
        under prefill backlog (``DynamicRateController.decode_budget``)."""
        base = self.decode_budget
        if self.controller is not None:
            base = self.controller.decode_budget(now, base)
        return float("inf") if base is None else float(base)

    def _run_piggyback(self, now: float, rid: int, ci: int) -> None:
        """The mixed-step half of a chunk event: the chunk that just ran
        occupies its instance group for the step window ``[now, now +
        chunk_duration)``.  Every colocated decode instance becomes busy
        for the window; with piggybacking enabled its resident batch then
        ticks *inside* the window as part of this fused step — each tick
        at ``piggyback_latency`` cost — until the window, the decode
        budget, or the batch runs out.  Inline ticks run through the
        normal ``_on_decode_tick`` path (real forward, preemption, CoW,
        hash publishing all included), so a fused step is behaviourally a
        timeline tick that happens to cost the chunk's slack."""
        if not self._decode_hosts:
            return
        req = self.reqs[rid]
        group = set(req.chunk_groups[ci])
        s0, s1 = req.chunk_sched[ci]
        t_end = now + max(0.0, s1 - s0)
        for did, hosts in self._decode_hosts.items():
            if not (group & hosts):
                continue
            self._busy_until[did] = max(self._busy_until.get(did, 0.0),
                                        t_end)
            if not self.piggyback:
                continue
            inst = self.decodes[did]
            budget = self._decode_budget_now(now)
            ticks, toks = 0, 0
            t = max(now, self._next_tick.get(did, now))
            while inst.batch:
                cache = sum(r.cache_tokens for r in inst.batch)
                pdt = self.decode_model.piggyback_latency(
                    len(inst.batch), cache, tp=self.spec.tp_decode)
                nb = len(inst.batch)
                if t + pdt > t_end + 1e-12 or toks + nb > budget:
                    break
                self._fused_tick = did
                try:
                    self._on_decode_tick(t, did)
                finally:
                    self._fused_tick = None
                ticks += 1
                toks += nb
                t = self._next_tick.get(did, t + pdt)
            if ticks:
                self.tracer.record(
                    now, "fused_step", rid=rid, track=("decode", did),
                    entry={"t": now, "rid": rid, "chunk": ci,
                           "instance": did, "ticks": ticks, "tokens": toks,
                           "window": t_end - now})

    def _tick_latency(self, d) -> float:
        if self._fused_tick == d.did:
            cache = sum(r.cache_tokens for r in d.batch)
            return self.decode_model.piggyback_latency(
                len(d.batch), cache, tp=self.spec.tp_decode)
        return super()._tick_latency(d)

    def _tick_mode(self, did: int) -> str:
        return "fused" if self._fused_tick == did else "standalone"

    def _on_decode_tick(self, now: float, did: int) -> None:
        d = self.dstates[did]
        inst = self.decodes[did]
        fused = self._fused_tick == did
        if not fused:
            nt = self._next_tick.get(did)
            if nt is not None and now < nt - 1e-12:
                # superseded: a fused step already ran this tick inside a
                # chunk window and re-armed the chain later — dropping
                # here is the "cancelled exactly once" half of coalescing
                return
            bu = self._busy_until.get(did, 0.0)
            if now < bu - 1e-12 and inst.batch:
                # colocated hosts are inside a prefill chunk's step
                # window: a standalone tick cannot run until it ends
                # (piggybacked ticks already ran as part of the step)
                inst.deferred_ticks += 1
                self.tracer.record(now, "defer", track=("decode", did),
                                   until=bu)
                self.metrics.counter("ticks/deferred").inc()
                self._push(bu, "decode_tick", did)
                return
        # every tick that passes while a recompute-preempted request is
        # away (re-prefilling, in transfer, or waiting on a batch row) is
        # a stalled token for that request — the drain-vs-restripe
        # benchmark's cost metric
        if self._stalled:
            self.stall_ticks += len(self._stalled)
            self.metrics.counter("restripe/stall_ticks").inc(
                len(self._stalled))
        self._grow_or_preempt(now, did)
        # rows claimed by an in-flight swap-in have no meta yet: the KV is
        # still crossing PCIe, so they sit this tick out
        active = [r for r in d.slots if r is not None and r in d.meta]
        if active:
            if fused:
                inst.piggyback_ticks += 1
                inst.piggyback_tokens += len(active)
            else:
                inst.standalone_ticks += 1
                inst.standalone_tokens += len(active)
        if active:
            B = d.max_batch
            toks = np.zeros((B, 1), np.int32)
            clen = np.zeros((B,), np.int32)
            for r in active:
                m = d.meta[r]
                toks[m.row, 0] = m.last_token
                clen[m.row] = m.cache_len
            toks = torch.as_tensor(toks, device=self.ctx.device)
            clen = torch.as_tensor(clen, device=self.ctx.device)
            pos = (clen[None, :, None].expand(3, B, 1)
                   if self.cfg.rope_type == "mrope" else clen[:, None])
            bt = d.block_table(active)
            caches = d.build_caches(active, bt)
            with self.profiler.op("fused_tick" if fused
                                  else "decode_tick"):
                logits, _, new_caches = forward(
                    self.params, self.cfg, self.ctx, toks, pos, "decode",
                    caches=caches, cache_len=clen)
                d.absorb(new_caches, active)
            nxt = torch.argmax(logits[:, 0, :self.cfg.vocab_size],
                               dim=-1).cpu().numpy()
            for r in active:
                m = d.meta[r]
                m.tokens.append(m.last_token)   # its KV landed this tick
                m.last_token = int(nxt[m.row])
                m.cache_len += 1
                self.outputs[r].append(int(nxt[m.row]))
                if self.prefix_sharing and m.cache_len % d.block_size == 0:
                    # a block filled *during decode*: extend the chained
                    # hash by just this block and publish it, so
                    # decode-grown prefixes are shareable by twin
                    # admissions and demotable to the host tier
                    bs = d.block_size
                    prev = m.hashes[-1] if m.hashes else 0
                    blk = m.tokens[len(m.hashes) * bs:m.cache_len]
                    m.hashes.append(hash((prev,) + tuple(blk)))
                    d.blocks.register_hashes(r, m.hashes, tokens=m.tokens)
        # virtual-time bookkeeping + token accounting via the parent
        inst = self.decodes[did]
        finished_before = {r.rid for r in inst.batch
                           if r.generated + 1 >= r.output_len}
        super()._on_decode_tick(now, did)
        for rid in finished_before:
            meta = d.evict(rid)
            if meta.shared_tokens:
                inst.debit_shared(meta.shared_tokens)
            self._decode_preempt_flags.discard(rid)
        if (finished_before and self.fabric.cross_instance
                and self.fabric.credit(did)):
            # a finishing resident freed real blocks: give borrowed
            # watermark headroom back to its donors
            self.fabric.release_borrowed(
                did, max(0, d.blocks.effective_free()
                         - self._watermark_blocks(d)))
