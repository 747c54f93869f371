"""Ring attention and the sharded paged islands, driven by one process.

The reference runs these as shard_map islands (its core/ring_attention.py):
the sequence is sharded over the SP axis, each device attends its local
queries to the KV shard it holds, then hands that shard to its ring
neighbour with ``lax.ppermute``; after n steps every query has seen every
key, and the partial results merge by log-sum-exp.  The port keeps the
reference's single controller: a mesh position is a ``torch.device``
(launch/mesh.py), a per-shard body runs for each position in turn, and
the collectives are list operations — ``ring_shift`` for the ppermute,
``all_gather`` for the split-KV merge.  A ``*_local`` function here takes
the per-position parts (lists, part i on position i's device) and returns
per-position results; its global-view twin takes whole tensors on
position 0's device, places the shards, and gathers the result back.

Every attention call is ``kernels/ops``: K3 (``flash_attention``) for the
ring steps, K1 (``paged_flash_decode``) for each shard's decode partial.
Masking is position-array driven, so CDSP history chunks need no special
case.

* ``ring_attention`` — contiguous layout, the chunk's own KV (and a dense
  history, when given) rotating through the ring;
* ``sharded_paged_decode`` — split-KV decode over a striped paged pool,
  the new token appended in place on the shard owning its page, fused
  with that shard's attend;
* ``ring_paged_prefill`` — a CDSP chunk over its striped paged history:
  each shard's history pages, assembled into a positional slab, rotate
  through the ring beside the chunk's own KV.

On a 2-D mesh the attention heads also shard over a TP axis (TP x SP):
``head_axis`` splits the query heads, and ``kv_head_axis`` the KV heads
and the pools (a head-sharded pool's shard is a list of its head slices,
serving/cache_manager.py).  Each TP index runs the SP island on its
heads, over the positions of its SP column (``Mesh.positions(sp_axis,
tp=t)``); the LSE merge stays over the SP axis, and the outputs meet,
side by side, on q's device.  Where the KV heads do not divide the TP
axis (n_kv < tp) they stay whole, replicated over TP, and each call
slices the range its query heads read (``head_shard``).

The zigzag causal skip (``_ring_zigzag_skip``), ``split_kv_decode`` /
``sharded_cache_update`` (dense split-KV decode) and ``sp_ssd`` (the
sequence-parallel SSD scan) are later slices of the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import INT32_MAX
from repro_torch.kernels.ref import NEG_INF, _broadcast_pos
from repro_torch.launch.mesh import (all_gather, head_part, head_stripes,
                                     ring_shift, split, to, unsplit)


def _lines(mesh, axis: str, head_axis: Optional[str]
           ) -> List[Tuple[torch.device, ...]]:
    """The positions along ``axis``, one line per index of ``head_axis``
    (the SP column of each TP index), or the one line without it."""
    if head_axis is None:
        return [mesh.positions(axis)]
    return [mesh.positions(axis, **{head_axis: t})
            for t in range(mesh.shape[head_axis])]


def _kv_head_range(H_loc: int, KVH: int, t: int, tp: int
                   ) -> Tuple[int, int]:
    """(first, count) of the KV heads that TP index ``t`` of ``tp``
    reads for its ``H_loc`` query heads, out of ``KVH`` KV heads kept
    whole (replicated over TP, n_kv < tp): reference
    ``ring_paged_prefill_local``'s per-call head slice."""
    if tp == 1 or KVH == 1:
        return 0, KVH
    group = (H_loc * tp) // KVH
    if group % H_loc and H_loc % group:
        raise ValueError(f"{H_loc} query heads a position do not tile "
                         f"GQA groups of {group}")
    return (t * H_loc) // group, max(1, H_loc // group)


def _read_heads(q, k, v, head_shard: Tuple[int, int], pools=()):
    """(k, v, *pools) narrowed to the KV heads TP index ``head_shard[0]``
    reads (``_kv_head_range``): the chunk's parts made contiguous, the
    pools left as views, which the slab gather copies."""
    first, count = _kv_head_range(q[0].shape[2], k[0].shape[2],
                                  *head_shard)
    return ([x.narrow(2, first, count).contiguous() for x in k],
            [x.narrow(2, first, count).contiguous() for x in v],
            *([x.narrow(2, first, count) for x in p] for p in pools))


def _stripes(mesh, pools, kv_head_axis: Optional[str]):
    """``head_stripes`` of a pool, one per index of ``kv_head_axis`` (a
    head-sharded pool), or the one stripe without it."""
    out = head_stripes(pools)
    want = 1 if kv_head_axis is None else mesh.shape[kv_head_axis]
    if len(out) != want:
        raise ValueError(
            f"a pool of {len(out)} head slices under kv_head_axis="
            f"{kv_head_axis!r}: a head-sharded pool needs the KV head "
            "axis, and the KV head axis a head-sharded pool")
    return out


def _merge(o, lse, o_i, lse_i):
    """Merge running (o, lse) with a new partial block (fp32).  o (B, S,
    H, D); lse (B, H, S)."""
    lse_new = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
    return o * w_old + o_i.float() * w_new, lse_new


def _init(q: torch.Tensor):
    B, S, H, _ = q.shape
    return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
            torch.full((B, H, S), NEG_INF, dtype=torch.float32,
                       device=q.device))


# ------------------------------------------------------------ ring (dense)
def _ring(q, q_pos, sources, *, devices: Sequence[torch.device],
          window: Optional[int], softmax_scale, impl: Optional[str]):
    """The ring loop both islands share.  ``sources`` is a list of (k, v,
    pos, causal): per-position KV parts that rotate together.  Each step
    every position attends its queries to each source part it holds (K3
    with lse, in ``sources`` order), merges, and every source moves one
    position on.  Returns (o, lse) per position, o in q's dtype."""
    n = len(devices)
    acc = [_init(qi) for qi in q]
    parts = [(list(k), list(v), list(p), c) for k, v, p, c in sources]
    for step in range(n):
        for i in range(n):
            for k_c, v_c, p_c, c in parts:
                o_i, lse_i = ops.attention(q[i], k_c[i], v_c[i], q_pos[i],
                                           p_c[i], causal=c, window=window,
                                           softmax_scale=softmax_scale,
                                           with_lse=True, impl=impl)
                acc[i] = _merge(*acc[i], o_i, lse_i)
        if step != n - 1:
            parts = [(ring_shift(k_c, devices), ring_shift(v_c, devices),
                      ring_shift(p_c, devices), c)
                     for k_c, v_c, p_c, c in parts]
    return ([o.to(qi.dtype) for (o, _), qi in zip(acc, q)],
            [lse for _, lse in acc])


def ring_attention_local(q, k, v, q_pos, kv_pos, *,
                         devices: Sequence[torch.device],
                         causal: bool = True, window: Optional[int] = None,
                         softmax_scale=None, impl: Optional[str] = None,
                         head_shard: Optional[Tuple[int, int]] = None):
    """The per-shard bodies of ring attention, one per position.

    q: list of (B, S_loc, H, D); k/v: lists of (B, S_kv_loc, KVH, D);
    q_pos / kv_pos: lists of (B, S_loc) / (B, S_kv_loc) int32 — part i on
    ``devices[i]``.  Each step every position attends its queries to the
    KV it holds (K3 with lse), merges, and the KV moves one position on.
    ``head_shard`` = (t, tp): q holds TP index t's slice of the query
    heads and the KV heads arrive whole (n_kv < tp); each position slices
    out the KV heads its query heads read before the ring, so the ring
    carries only those (reference ``head_shard_axis``).  Returns (o,
    lse): lists of (B, S_loc, H, D) in q's dtype and (B, H, S_loc)
    fp32."""
    if head_shard is not None:
        k, v = _read_heads(q, k, v, head_shard)
    return _ring(q, q_pos, [(k, v, kv_pos, causal)], devices=devices,
                 window=window, softmax_scale=softmax_scale, impl=impl)


def ring_attention(q, k, v, q_pos, kv_pos, *, mesh, sp_axis: str,
                   head_axis: Optional[str] = None,
                   kv_head_axis: Optional[str] = None,
                   causal: bool = True, window: Optional[int] = None,
                   softmax_scale=None, impl: Optional[str] = None):
    """Global-view ring attention: q (B, S, H, D), k/v (B, S_kv, KVH, D)
    and their positions ((S,) or (B, S) int32) on position 0's device,
    both sequence dims split contiguously over ``sp_axis``.  With
    ``head_axis`` (TP) each TP index rings its slice of the query heads
    over its SP column; ``kv_head_axis`` (the same axis, when KVH divides
    it) slices the KV heads alike, else every TP index slices the KV
    heads its queries read.  Returns (B, S, H, D) on q's device."""
    if kv_head_axis is not None and kv_head_axis != head_axis:
        raise ValueError(f"kv_head_axis={kv_head_axis!r} needs the query "
                         f"heads on the same axis, not {head_axis!r}")
    lines = _lines(mesh, sp_axis, head_axis)
    tp = len(lines)
    kv_tp = tp if kv_head_axis is not None else 1
    B = q.shape[0]
    outs = []
    for t, devices in enumerate(lines):
        o, _ = ring_attention_local(
            split(head_part(q, t, tp, 2), devices),
            split(head_part(k, t, kv_tp, 2), devices),
            split(head_part(v, t, kv_tp, 2), devices),
            split(_broadcast_pos(q_pos, B), devices),
            split(_broadcast_pos(kv_pos, B), devices),
            devices=devices, causal=causal, window=window,
            softmax_scale=softmax_scale, impl=impl,
            head_shard=(t, tp) if head_axis is not None
            and kv_head_axis is None else None)
        outs.append(unsplit(o, q.device))
    return torch.cat(outs, dim=2)


# ----------------------------------------------------- sharded paged decode
def _lse_merge_over_axis(o_parts: Sequence[torch.Tensor],
                         lse_parts: Sequence[torch.Tensor],
                         device: torch.device) -> torch.Tensor:
    """All-gather per-shard (o, lse) partials onto ``device`` and merge
    them by log-sum-exp — the split-KV combine.  o_i (B, H, D); lse_i
    (B, H).  Returns fp32 (B, H, D)."""
    o_all = all_gather([o.float() for o in o_parts], device)  # (n, B, H, D)
    lse_all = all_gather(lse_parts, device)                   # (n, B, H)
    lse = torch.logsumexp(lse_all, dim=0)
    w = torch.exp(lse_all - lse[None])
    return torch.sum(o_all * w[..., None], dim=0)


def _local_page_slab(k_loc, v_loc, bt_loc, lengths, n: int, idx: int):
    """Assemble one shard's pages into a positional KV slab.

    Gathers the local pages in table order and computes each slot's
    GLOBAL token position from the stripe layout (local page j holds
    global page ``j * n + idx``); slots at/past the valid length —
    scratch-padded table columns included — are pushed to INT32_MAX,
    where causal position masking retires them.  Returns (k_slab, v_slab,
    positions), each (B, npg_local * page, ...), contiguous."""
    B, npg = bt_loc.shape
    page = k_loc.shape[1]
    ids = bt_loc.long()
    kg = k_loc[ids].reshape(B, npg * page, *k_loc.shape[2:])
    vg = v_loc[ids].reshape(B, npg * page, *v_loc.shape[2:])
    dev = k_loc.device
    gpage = torch.arange(npg, dtype=torch.int32, device=dev) * n + idx
    pos = (gpage[:, None] * page + torch.arange(
        page, dtype=torch.int32, device=dev)[None]).reshape(1, -1)
    pos = torch.where(pos < lengths[:, None], pos,
                      torch.full_like(pos, INT32_MAX))
    return kg, vg, pos.expand(B, npg * page).contiguous()


def sharded_paged_decode_local(q, k_loc, v_loc, bt_loc, lengths, *,
                               n: int, idx: int,
                               window: Optional[int] = None,
                               softmax_scale=None, impl: Optional[str] = None,
                               k_new=None, v_new=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The body of the split-KV *paged* decode on position ``idx`` of an
    ``n``-wide live stripe; returns this shard's partial (o (B, H, D),
    lse (B, H)) for ``_lse_merge_over_axis``.

    k_loc/v_loc: (blocks_per_shard + 1, page, KVH, D), this shard's pool
    (the last page is scratch); bt_loc: (B, npg_local) local page ids,
    column j holding the sequence's logical page ``j * n + idx``;
    lengths: (B,) GLOBAL valid lengths (excluding the new token when
    ``k_new`` is given); every tensor on this shard's device.

    The new token's K/V is appended by the shard owning the page that
    position ``lengths`` falls in (every other shard routes the write to
    its scratch page, which no table column reads as live history), fused
    with the attend: one K1 call writes the pool in place and attends.
    Length and window masks follow the stripe natively: the shard passes
    ``page_pos`` — each column's first-token GLOBAL position — and K1
    masks by global position over every column of the table.  A shard at
    ``idx >= n`` (elastically narrowed stripe) holds no pages: its
    lengths mask to zero, so its partial has lse = NEG_INF and weight 0."""
    if idx >= n:
        lengths = torch.zeros_like(lengths)
    B, npg = bt_loc.shape
    page = k_loc.shape[1]
    dev = k_loc.device
    gpage = torch.arange(npg, dtype=torch.int32, device=dev) * n + idx
    page_pos = (gpage * page)[None].expand(B, npg)
    if k_new is None:
        return ops.paged_decode_attention(
            q, k_loc, v_loc, bt_loc, lengths, window=window,
            softmax_scale=softmax_scale, with_lse=True, impl=impl,
            page_pos=page_pos)
    tgt = lengths.long() // page                           # global page
    own = (tgt % n) == idx
    rows = torch.arange(B, device=dev)
    col = torch.clamp(tgt // n, 0, npg - 1)
    phys = torch.where(own, bt_loc[rows, col].long(),
                       torch.full_like(col, k_loc.shape[0] - 1))
    o_i, lse_i, _, _ = ops.paged_decode_attention(
        q, k_loc, v_loc, bt_loc, lengths, window=window,
        softmax_scale=softmax_scale, with_lse=True, impl=impl,
        page_pos=page_pos, k_new=k_new, v_new=v_new, append_page=phys,
        append_slot=lengths % page)
    return o_i, lse_i


def sharded_paged_decode(q, k_pool, v_pool, block_tables, lengths, *,
                         mesh, split_axis: str,
                         head_axis: Optional[str] = None,
                         window: Optional[int] = None, softmax_scale=None,
                         impl: Optional[str] = None,
                         k_new=None, v_new=None,
                         active_shards: Optional[int] = None):
    """Split-KV decode over a sequence-parallel *sharded paged* pool.

    q: (B, H, D) on position 0's device; k_pool/v_pool: per-shard pools,
    a list of (blocks_per_shard + 1, page, KVH, D), shard s on position s
    of ``split_axis`` (the engine's striped PagedKVCache layout, one
    layer); block_tables: (n, B, npg_local) per-shard local page ids;
    lengths: (B,) global cache lengths EXCLUDING the new token when
    (k_new, v_new): (B, KVH, D) are given — the append lands in place in
    the owning shard's pool, fused with its attend.  Each shard computes
    its partial over its own pages; the partials meet on q's device and
    merge by LSE.  Returns (o, k_pool, v_pool), the pools being the same
    lists, written in place.  ``active_shards`` narrows the stripe to the
    first so-many shards (rows past it must be all-scratch).

    ``head_axis`` (TP, only where KVH divides it) takes a head-sharded
    pool, shard s a list of its head slices over TP: each TP index t
    runs the island over its SP column with its slice of the query heads
    and of k_new / v_new, against slice t of every shard's pool; the
    LSE merge stays over ``split_axis``, and the heads' outputs are put
    side by side."""
    kps, vps = (_stripes(mesh, p, head_axis) for p in (k_pool, v_pool))
    lines = _lines(mesh, split_axis, head_axis)
    tp = len(lines)
    if len(k_pool) != len(lines[0]) or block_tables.shape[0] != len(k_pool):
        raise ValueError(f"{len(k_pool)} pool shards and a table of "
                         f"{block_tables.shape[0]} rows over "
                         f"{len(lines[0])} positions")
    n = len(k_pool) if active_shards is None else active_shards
    outs = []
    for t, (devices, kp, vp) in enumerate(zip(lines, kps, vps)):
        q_t = head_part(q, t, tp, 1).contiguous()
        kn = None if k_new is None else head_part(k_new, t, tp,
                                                  1).contiguous()
        vn = None if v_new is None else head_part(v_new, t, tp,
                                                  1).contiguous()
        parts = []
        for idx, dev in enumerate(devices):
            parts.append(sharded_paged_decode_local(
                to(q_t, dev), kp[idx], vp[idx], to(block_tables[idx], dev),
                to(lengths, dev), n=n, idx=idx, window=window,
                softmax_scale=softmax_scale, impl=impl,
                k_new=None if kn is None else to(kn, dev),
                v_new=None if vn is None else to(vn, dev)))
        outs.append(_lse_merge_over_axis([p[0] for p in parts],
                                         [p[1] for p in parts], q.device))
    return torch.cat(outs, dim=1).to(q.dtype), k_pool, v_pool


# ------------------------------------------------------- ring paged prefill
def ring_paged_prefill_local(q, k, v, q_pos, kv_pos, k_pool, v_pool, bt,
                             hist_len, *, devices: Sequence[torch.device],
                             causal: bool = True,
                             window: Optional[int] = None,
                             softmax_scale=None, impl: Optional[str] = None,
                             head_shard: Optional[Tuple[int, int]] = None,
                             active_shards: Optional[int] = None
                             ) -> Tuple[List[torch.Tensor],
                                        List[torch.Tensor]]:
    """The per-shard bodies of CDSP chunk prefill against *sharded paged*
    history, one per position.

    q/k/v/q_pos/kv_pos: lists of the chunk's local sequence shards, as in
    ``ring_attention_local``; k_pool/v_pool: the per-shard pools; bt:
    list of (B, npg_local) local page ids (logical page ``j * n + idx``
    at column j); hist_len: list of (B,) global history lengths.  Each
    shard assembles its history pages into a positional slab, and the
    ring rotates BOTH the chunk's own KV and the slabs: two K3 calls per
    position and step (the own-chunk KV under ``causal``, the slab always
    causal, its dead slots at INT32_MAX), merged by LSE.  The ring
    rotates over every position; only the history stripe narrows to
    ``active_shards``, idle shards contributing an empty slab.  The slabs
    live until the function returns, one layer at a time.

    KV heads come in one of two layouts.  Head-sharded (TP x SP): the
    pools and the chunk's KV are already this TP index's head slice.
    Replicated over TP (n_kv < tp): ``head_shard`` = (t, tp) makes each
    position slice out the KV heads its query heads read, of the chunk's
    KV and of the pool, whose slab gather then copies only those."""
    n = len(devices)
    if head_shard is not None:
        k, v, k_pool, v_pool = _read_heads(q, k, v, head_shard,
                                           (k_pool, v_pool))
    n_hist = n if active_shards is None else active_shards
    slabs = [tuple(to(x, devices[i]) for x in _local_page_slab(
        k_pool[i], v_pool[i], bt[i],
        hist_len[i] if i < n_hist else torch.zeros_like(hist_len[i]),
        n_hist, i)) for i in range(n)]
    hist = tuple(list(x) for x in zip(*slabs))
    del slabs
    return _ring(q, q_pos, [(k, v, kv_pos, causal), (*hist, True)],
                 devices=devices, window=window,
                 softmax_scale=softmax_scale, impl=impl)


def ring_paged_prefill(q, k, v, q_pos, kv_pos, k_pool, v_pool, block_tables,
                       hist_len, *, mesh, sp_axis: str,
                       head_axis: Optional[str] = None,
                       kv_head_axis: Optional[str] = None,
                       causal: bool = True,
                       window: Optional[int] = None, softmax_scale=None,
                       impl: Optional[str] = None,
                       active_shards: Optional[int] = None):
    """Global-view ring attention for a CDSP chunk whose cross-chunk
    history lives in a sequence-parallel sharded page pool.

    q (B, S, H, D), k/v (B, S, KVH, D) and positions on position 0's
    device, split contiguously over ``sp_axis``; k_pool/v_pool: per-shard
    pools (one layer) on the same axis; block_tables (n, B, npg_local);
    hist_len (B,).  History pages rotate through the ring beside the
    chunk's own KV shards, never leaving their owner's pool.  With
    ``head_axis`` (TP) each TP index rings its slice of the query heads
    over its SP column.  ``kv_head_axis`` (the same axis, KVH dividing
    it) marks the pool head-sharded: the chunk's KV is sliced alike and
    each TP index reads its own slice of the pool; without it the pool
    is whole and every position slices the KV heads its queries read.
    Returns (B, S, H, D) on q's device."""
    if kv_head_axis is not None and kv_head_axis != head_axis:
        raise ValueError(f"kv_head_axis={kv_head_axis!r} needs the query "
                         f"heads on the same axis, not {head_axis!r}")
    lines = _lines(mesh, sp_axis, head_axis)
    tp = len(lines)
    if len(k_pool) != len(lines[0]) or block_tables.shape[0] != len(k_pool):
        raise ValueError(f"{len(k_pool)} pool shards and a table of "
                         f"{block_tables.shape[0]} rows over "
                         f"{len(lines[0])} positions")
    kps, vps = (_stripes(mesh, p, kv_head_axis) for p in (k_pool, v_pool))
    B = q.shape[0]
    sharded = kv_head_axis is not None
    kv_tp = tp if sharded else 1
    outs = []
    for t, devices in enumerate(lines):
        o, _ = ring_paged_prefill_local(
            split(head_part(q, t, tp, 2), devices),
            split(head_part(k, t, kv_tp, 2), devices),
            split(head_part(v, t, kv_tp, 2), devices),
            split(_broadcast_pos(q_pos, B), devices),
            split(_broadcast_pos(kv_pos, B), devices),
            kps[t if sharded else 0], vps[t if sharded else 0],
            [to(block_tables[i], d) for i, d in enumerate(devices)],
            [to(hist_len, d) for d in devices], devices=devices,
            causal=causal, window=window, softmax_scale=softmax_scale,
            impl=impl, head_shard=(t, tp) if head_axis is not None
            and not sharded else None, active_shards=active_shards)
        outs.append(unsplit(o, q.device))
    return torch.cat(outs, dim=2)
