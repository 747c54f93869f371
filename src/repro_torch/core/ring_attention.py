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

Also here:

* ``zigzag_skip`` of the dense ring (``_ring_zigzag_skip``) — for a
  prefill stored in zigzag order (core/zigzag.py) each position skips the
  KV halves its queries cannot see: one K3 call at step 0, two at each
  later step;
* ``split_kv_decode`` — split-KV decode over a dense cache laid out as
  per-position sequence shards (K4 per shard through
  ``ops.decode_attention`` with the shard's ``kv_offset``, then the LSE
  merge), the new token written in place into the owning shard;
  ``sharded_cache_update`` is that write alone;
* ``sp_ssd`` — the sequence-parallel SSD scan: K5 per position from a
  zero state, the positions' (decay, state) summaries composed on the
  host's loop behind the incoming CDSP state, and the fp32 correction of
  each position's outputs by the state it should have started from.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import INT32_MAX
from repro_torch.kernels.ref import NEG_INF, _broadcast_pos
from repro_torch.launch.mesh import (all_gather, at, head_part,
                                     head_stripes, ring_shift, split, to,
                                     unsplit)


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
            with at(devices, i):
                for k_c, v_c, p_c, c in parts:
                    o_i, lse_i = ops.attention(
                        q[i], k_c[i], v_c[i], q_pos[i], p_c[i], causal=c,
                        window=window, softmax_scale=softmax_scale,
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
                         head_shard: Optional[Tuple[int, int]] = None,
                         zigzag_skip: bool = False):
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
    fp32.  ``zigzag_skip`` (a zigzag layout: position d holds slices d
    and 2n-1-d) takes ``_ring_zigzag_skip`` where the reference does:
    causal, no window, more than one position, q and KV of one length,
    and that length even."""
    if head_shard is not None:
        k, v = _read_heads(q, k, v, head_shard)
    n = len(devices)
    S, S_kv = q[0].shape[1], k[0].shape[1]
    if zigzag_skip and causal and window is None and n > 1 \
            and S == S_kv and S % 2 == 0:
        return _ring_zigzag_skip(q, k, v, q_pos, kv_pos, devices=devices,
                                 softmax_scale=softmax_scale, impl=impl)
    return _ring(q, q_pos, [(k, v, kv_pos, causal)], devices=devices,
                 window=window, softmax_scale=softmax_scale, impl=impl)


def _halves(x: torch.Tensor, dim: int = 1):
    """The early and late halves of a zigzag shard along ``dim``, each
    contiguous (K3 reads contiguous bf16 operands)."""
    h = x.shape[dim] // 2
    return (x.narrow(dim, 0, h).contiguous(),
            x.narrow(dim, h, x.shape[dim] - h).contiguous())


def _ring_zigzag_skip(q, k, v, q_pos, kv_pos, *,
                      devices: Sequence[torch.device], softmax_scale,
                      impl: Optional[str]):
    """Causal-skip ring attention for the zigzag layout (reference
    ``_ring_zigzag_skip``).

    Position d's queries are slices {d, 2n-1-d} ("early" / "late"), and
    the KV it holds at ring step t came from position j = (d - t) % n,
    slices {j, 2n-1-j}.  Causality gives, for t > 0:
      q_late  x kv_early: always fully visible (computed every step);
      q_early x kv_early: visible iff j < d;  exactly one of these two
      q_late  x kv_late:  visible iff j > d;  is visible (pair B);
      q_early x kv_late:  never visible (skipped).
    The reference computes B as a data select so that every device runs
    one program; here each position knows d and j on the host, so it
    launches only the pair B that is visible.  Step 0 (the local
    diagonal) is one causal call over the whole shard.  Position masks
    inside K3 do the rest."""
    def attend(qq, qp, kk, vv, kp):
        return ops.attention(qq, kk, vv, qp, kp, causal=True,
                             softmax_scale=softmax_scale, with_lse=True,
                             impl=impl)

    n = len(devices)
    qh = [(_halves(q[i]), _halves(q_pos[i])) for i in range(n)]
    acc = [{"e": _init(qe), "l": _init(ql)} for (qe, ql), _ in qh]
    k_c, v_c, p_c = list(k), list(v), list(kv_pos)
    def step(t, d):
        a = acc[d]
        if t == 0:
            o_i, lse_i = attend(q[d], q_pos[d], k_c[d], v_c[d], p_c[d])
            oe, ol = _halves(o_i)
            le, ll = _halves(lse_i, 2)
            a["e"] = _merge(*a["e"], oe, le)
            a["l"] = _merge(*a["l"], ol, ll)
            return
        (q_e, q_l), (qp_e, qp_l) = qh[d]
        k_e, k_l = _halves(k_c[d])
        v_e, v_l = _halves(v_c[d])
        kp_e, kp_l = _halves(p_c[d])
        # A: q_late x kv_early, always fully visible
        a["l"] = _merge(*a["l"], *attend(q_l, qp_l, k_e, v_e, kp_e))
        # B: (q_early x kv_early) if j < d else (q_late x kv_late)
        if (d - t) % n < d:
            a["e"] = _merge(*a["e"], *attend(q_e, qp_e, k_e, v_e, kp_e))
        else:
            a["l"] = _merge(*a["l"], *attend(q_l, qp_l, k_l, v_l, kp_l))

    for t in range(n):
        for d in range(n):
            with at(devices, d):
                step(t, d)
        if t != n - 1:
            k_c, v_c, p_c = (ring_shift(x, devices) for x in (k_c, v_c, p_c))
    return ([torch.cat([a["e"][0], a["l"][0]], dim=1).to(qi.dtype)
             for a, qi in zip(acc, q)],
            [torch.cat([a["e"][1], a["l"][1]], dim=2) for a in acc])


def ring_attention(q, k, v, q_pos, kv_pos, *, mesh, sp_axis: str,
                   head_axis: Optional[str] = None,
                   kv_head_axis: Optional[str] = None,
                   causal: bool = True, window: Optional[int] = None,
                   softmax_scale=None, impl: Optional[str] = None,
                   zigzag_skip: bool = False):
    """Global-view ring attention: q (B, S, H, D), k/v (B, S_kv, KVH, D)
    and their positions ((S,) or (B, S) int32) on position 0's device,
    both sequence dims split contiguously over ``sp_axis``.  With
    ``head_axis`` (TP) each TP index rings its slice of the query heads
    over its SP column; ``kv_head_axis`` (the same axis, when KVH divides
    it) slices the KV heads alike, else every TP index slices the KV
    heads its queries read.  ``zigzag_skip`` enables the causal-skip path
    (valid only when the storage layout is zigzag).  Returns (B, S, H, D)
    on q's device."""
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
            and kv_head_axis is None else None, zigzag_skip=zigzag_skip)
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
            with at(devices, idx):
                parts.append(sharded_paged_decode_local(
                    to(q_t, dev), kp[idx], vp[idx],
                    to(block_tables[idx], dev), to(lengths, dev), n=n,
                    idx=idx, window=window, softmax_scale=softmax_scale,
                    impl=impl, k_new=None if kn is None else to(kn, dev),
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
    slabs = []
    for i in range(n):
        with at(devices, i):
            slabs.append(tuple(to(x, devices[i]) for x in _local_page_slab(
                k_pool[i], v_pool[i], bt[i],
                hist_len[i] if i < n_hist else torch.zeros_like(hist_len[i]),
                n_hist, i)))
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


# ----------------------------------------------------- dense split-KV decode
def _shards(cache, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """A dense cache's per-position sequence shards, shard i on position
    i of the split axis."""
    if not isinstance(cache, (list, tuple)) or len(cache) != len(devices):
        raise ValueError(
            "a split-KV dense cache is a list of per-position sequence "
            f"shards, one for each of {len(devices)} positions "
            "(core.cdsp.shard_dense_caches)")
    return list(cache)


def _owner_writes(ks, vs, k_new, v_new, positions,
                  devices: Sequence[torch.device]) -> None:
    """Write one token's K/V a row, in place, into the shard of a
    sequence-sharded cache (``ks``/``vs``, shard i on ``devices[i]``)
    that owns the row's global position (reference
    ``sharded_cache_update``'s body).  On a device the owning shards are
    read back once (a few bytes), and only they write, only their rows.
    On ``meta`` tensors, which hold no values (the dry run), every shard
    writes every row by a select, as the reference does: a row a shard
    does not own writes its clamped slot's own value back."""
    n, s_loc = len(devices), ks[0].shape[1]
    local = positions.long()[None] - s_loc * torch.arange(
        n, device=positions.device)[:, None]                 # (n, B)
    mine = (local >= 0) & (local < s_loc)
    slot = local.clamp(0, s_loc - 1)
    select = positions.is_meta
    owners = (range(n) if select
              else mine.any(dim=1).nonzero().flatten().tolist())
    for i in owners:
        d = devices[i]
        with at(devices, i):
            m, sl = to(mine[i], d), to(slot[i], d)
            rows = (torch.arange(len(sl), device=d) if select
                    else torch.nonzero(m).flatten())
            for cache, new in ((ks[i], k_new), (vs[i], v_new)):
                new = to(new, d)[rows].to(cache.dtype)
                if select:
                    new = torch.where(m[:, None, None], new, cache[rows, sl])
                cache[rows, sl[rows]] = new


def split_kv_decode_local(q, k_loc, v_loc, lengths, *, idx: int,
                          window: Optional[int] = None, softmax_scale=None,
                          impl: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard ``idx``'s partial of a flash decode over a sequence-sharded
    dense cache: q (B, H, D); k_loc/v_loc (B, S_loc, KVH, D), keys at
    global positions ``idx * S_loc + j``; lengths (B,) GLOBAL valid
    lengths.  One K4 call (``ops.decode_attention`` with ``kv_offset``)
    masks by global position, so a window that straddles shards needs no
    special case, and a shard past a row's length gives o = 0 and lse =
    NEG_INF (weight 0 in the merge).  (The reference clips a local length
    instead; both select the same keys.)  Returns (o, lse)."""
    return ops.decode_attention(q, k_loc, v_loc, lengths, window=window,
                                softmax_scale=softmax_scale, with_lse=True,
                                kv_offset=idx * k_loc.shape[1], impl=impl)


def split_kv_decode(q, k_cache, v_cache, lengths, *, mesh, split_axis,
                    window: Optional[int] = None, softmax_scale=None,
                    impl: Optional[str] = None, k_new=None, v_new=None):
    """Split-KV decode over a sequence-sharded dense cache: ship the tiny
    queries to the KV, never the KV to the queries.

    q (B, H, D) on position 0's device.  k_cache/v_cache: the cache's
    per-position sequence shards, a list of (B, S_loc, KVH, D) with shard
    i on position i of ``split_axis`` (``core.cdsp.shard_dense_caches``
    lays them out).  ``split_axis`` may be a tuple of
    axes (the collapsed split; shard order row-major).  With (k_new,
    v_new) (B, KVH, D) the new token's KV is written in place into the
    shard owning position ``lengths`` (which then EXCLUDES the new token;
    attention runs over lengths + 1).  Each shard computes its partial
    (K4), the partials meet on q's device and merge by LSE.  Returns (o,
    k_cache, v_cache)."""
    devices = mesh.positions(split_axis)
    ks, vs = _shards(k_cache, devices), _shards(v_cache, devices)
    if k_new is not None:
        _owner_writes(ks, vs, k_new, v_new, lengths, devices)
        lengths = lengths + 1
    parts = []
    for i, d in enumerate(devices):
        with at(devices, i):
            parts.append(split_kv_decode_local(
                to(q, d), ks[i], vs[i], to(lengths, d), idx=i,
                window=window, softmax_scale=softmax_scale, impl=impl))
    o = _lse_merge_over_axis([p[0] for p in parts], [p[1] for p in parts],
                             q.device).to(q.dtype)
    return o, k_cache, v_cache


def sharded_cache_update(k_cache, v_cache, k_new, v_new, positions, *,
                         mesh, split_axis):
    """Write one token's KV a row at ``positions`` (B,) into a sequence-
    sharded dense cache without leaving the sharded layout: the write
    lands in place in the shard owning each position.  Caches as in
    ``split_kv_decode``.  Returns (k_cache, v_cache)."""
    devices = mesh.positions(split_axis)
    ks, vs = _shards(k_cache, devices), _shards(v_cache, devices)
    _owner_writes(ks, vs, k_new, v_new, positions, devices)
    return k_cache, v_cache


# ------------------------------------------------ sequence-parallel SSD
def _ssd_scan_combine(a, b):
    """Compose segment summaries (decay, state): apply segment b after
    a."""
    da, sa = a
    db, sb = b
    return da * db, sa * db[..., None, None] + sb


def sp_ssd_local(x, dt, A, Bm, Cm, *, devices: Sequence[torch.device],
                 chunk: int = 128, h0=None, impl: Optional[str] = None
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The per-position bodies of the sequence-parallel SSD scan
    (contiguous layout): x/dt/Bm/Cm lists of each position's contiguous
    sequence shard, (B, S_loc, H, P) / (B, S_loc, H) / (B, S_loc, G, N),
    part i on ``devices[i]``; A (H,); h0 (B, H, P, N) or None, the
    incoming CDSP state.

    Each position scans its shard from a zero state (K5 through
    ``ops.ssd``) and summarises it as (decay d_i = exp(sum dt A), state
    s_i).  The reference composes the summaries with a ppermute prefix
    scan; here the host's loop composes them position by position, the
    summaries moving one position on, so position i starts from h_in_i =
    the composition of s_0..s_{i-1}, plus h0 carried through their decays.
    Each position then corrects its outputs in fp32, y += C exp(a_cum)
    h_in, and its state becomes h_in d_i + s_i; the last position's is
    the final state.  Returns (y parts in x's dtype, h_out parts fp32)."""
    n = len(devices)
    G = Bm[0].shape[2]
    outs, h_in, d_excl = [], None, None
    for i in range(n):
        with at(devices, i):
            dev = devices[i]
            y0, s_loc = ops.ssd(x[i], dt[i], to(A, dev), Bm[i], Cm[i],
                                h0=None, chunk=chunk, impl=impl)
            a = dt[i].float() * to(A, dev).float()[None, None, :]  # (B,S,H)
            d_loc = torch.exp(a.sum(dim=1))                         # (B,H)
            hi = (torch.zeros_like(s_loc) if h_in is None
                  else to(h_in, dev))
            if h0 is not None:
                de = (torch.ones_like(d_loc) if d_excl is None
                      else to(d_excl, dev))
                hi = hi + to(h0, dev).float() * de[..., None, None]
            rep = x[i].shape[2] // G
            Cf = torch.repeat_interleave(Cm[i].float(), rep,
                                         dim=2)                 # (B,S,H,N)
            a_cum = torch.cumsum(a, dim=1)
            y_corr = torch.einsum("bshn,bsh,bhpn->bshp", Cf,
                                  torch.exp(a_cum), hi)
            outs.append(((y0.float() + y_corr).to(x[i].dtype),
                         hi * d_loc[..., None, None] + s_loc))
            # the prefix of summaries 0..i, without h0 (reference: the
            # inclusive scan over (d, s))
            if h_in is None:
                d_excl, h_in = d_loc, s_loc
            else:
                d_excl, h_in = _ssd_scan_combine(
                    (to(d_excl, dev), to(h_in, dev)), (d_loc, s_loc))
    return [o[0] for o in outs], [o[1] for o in outs]


def sp_ssd(x, dt, A, Bm, Cm, *, mesh, sp_axis: str, chunk: int = 128,
           h0=None, head_axis: Optional[str] = None,
           impl: Optional[str] = None):
    """Sequence-parallel SSD: x (B, S, H, P), dt (B, S, H), Bm/Cm (B, S,
    G, N) and h0 (B, H, P, N) on position 0's device, the sequence split
    contiguously over ``sp_axis``.  With ``head_axis`` (TP; the caller
    passes it only for G == 1) each TP index scans its slice of the heads
    over its SP column.  Returns (y (B, S, H, P) in x's dtype, the final
    state (B, H, P, N) fp32), both on x's device."""
    lines = _lines(mesh, sp_axis, head_axis)
    tp = len(lines)
    ys, hs = [], []
    for t, devices in enumerate(lines):
        y, h = sp_ssd_local(
            split(head_part(x, t, tp, 2), devices),
            split(head_part(dt, t, tp, 2), devices),
            head_part(A, t, tp, 0), split(Bm, devices), split(Cm, devices),
            devices=devices, chunk=chunk,
            h0=None if h0 is None else head_part(h0, t, tp, 1),
            impl=impl)
        ys.append(unsplit(y, x.device))
        hs.append(to(h[-1], x.device))
    return torch.cat(ys, dim=2), torch.cat(hs, dim=1)
