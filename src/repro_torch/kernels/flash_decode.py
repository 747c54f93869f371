"""Decode kernels (CUDA, ``csrc/paged_decode.cu``), their plain PyTorch
versions, and the page helpers of the serving engine's block pools.

* ``paged_flash_decode`` (K1) — one query token per row against a paged
  pool (n_pages, page, KVH, D) through a block table (B, npg); length and
  window masks follow the per-column ``page_pos``; returns ``(o, lse)``.
  With ``k_new``/``v_new`` it is the fused decode tick: the new token's
  K/V is written at ``(append_page, append_slot)`` in place and the row
  attends over ``lengths + 1`` keys.  Replaces the Pallas
  ``paged_flash_decode`` reached through ``paged_append_attend``.
* ``flash_decode`` (K4) — one query token per row against a dense cache
  (B, S, KVH, D): key j sits at position ``kv_offset + j`` and is valid
  while below ``lengths`` and, with ``window``, at or above
  ``lengths - window``; returns ``(o, lse)``, with ``o = 0`` and
  ``lse = -1e30`` for a row with no valid key.  Any S.  Replaces the
  Pallas ``flash_decode``.  It runs the split-KV design of K1, with the
  row's keys cut into virtual pages.
* Page helpers (``scatter_kv_chunk``, ``copy_kv_blocks``,
  ``gather_kv_blocks``, ``scatter_kv_blocks``, ``copy_kv_block_within``,
  and the validation helpers ``gather_kv_pages``, ``scatter_kv_token``,
  ``scatter_kv_prefill``) are indexing, not kernels: the reference runs
  them as XLA scatters on donated buffers, here they write the live pool
  tensors in place.  Pools carry the layer axis first, (nb, n_pages,
  page, KVH, D).
* Their sharded twins (``shard_*``) run over a striped pool: a list of
  per-shard pools (nb, blocks_per_shard + 1, page, KVH, D), each on its
  mesh position's device, addressed by per-shard local page ids.  Each
  shard's pages stay on its position; local id ``blocks_per_shard`` is
  the shard's scratch page, and routing a payload there says "not
  mine".  A head-sharded pool (TP x SP) is a list over shards of lists
  over TP indices, each holding a slice of the KV heads; the helpers
  take each slice's share of a payload and put gathered slices back
  side by side.  ``shard_restripe_kv_blocks`` is the one helper that
  moves pages between shards (a live stripe resize).  The reference's
  are shard_map bodies (its flash_decode.py sharded page ops); here one
  process loops over the shards.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import _DTYPES, _check
from repro_torch.launch.mesh import head_part, head_stripes

# Position base for table columns past a sequence's allocation: far past
# any real length, and small enough that base + slot never overflows int32.
POS_PAD = 2 ** 30


# ------------------------------------------------------------ page helpers
def scatter_kv_chunk(pool: torch.Tensor, blocks: torch.Tensor,
                     seq_kv: torch.Tensor, positions: torch.Tensor) -> None:
    """Write one chunk's KV (nb, L, KVH, D) at its logical ``positions``
    (L,): token j lands in page ``blocks[positions[j] // page]`` at slot
    ``positions[j] % page``."""
    page = pool.shape[2]
    pos = positions.long()
    pool[:, blocks.long()[pos // page], pos % page] = seq_kv.to(pool.dtype)


def copy_kv_blocks(dst_pool: torch.Tensor, src_pool: torch.Tensor,
                   src_blocks: torch.Tensor, dst_blocks: torch.Tensor) -> None:
    """Copy whole pages between two pools (prefill -> decode admission)."""
    dst_pool[:, dst_blocks.long()] = src_pool[:, src_blocks.long()].to(
        dst_pool.device, dst_pool.dtype)


def gather_kv_blocks(pool: torch.Tensor, blocks: torch.Tensor
                     ) -> torch.Tensor:
    """Pages ``blocks`` out of a pool: (nb, n, page, KVH, D), a copy."""
    return pool[:, blocks.long()]


def scatter_kv_blocks(pool: torch.Tensor, blocks: torch.Tensor,
                      pages: torch.Tensor) -> None:
    """Write whole pages (nb, n, page, KVH, D) into ``blocks`` (swap-in,
    host prefix promotion)."""
    pool[:, blocks.long()] = pages.to(pool.device, pool.dtype)


def copy_kv_block_within(pool: torch.Tensor, src_block: int,
                         dst_block: int) -> None:
    """Copy one page onto another in the same pool (copy-on-write split)."""
    pool[:, dst_block] = pool[:, src_block]


def gather_kv_pages(pool: torch.Tensor, block_table: torch.Tensor
                    ) -> torch.Tensor:
    """Dense view of paged KV, a copy (validation helper: the serving path
    reads the pool through block tables and never builds this).  pool
    (nb, n_pages, page, KVH, D), block_table (B, npg) physical ids ->
    (nb, B, npg * page, KVH, D)."""
    nb = pool.shape[0]
    B, npg = block_table.shape
    g = pool[:, block_table.long()]          # (nb, B, npg, page, KVH, D)
    return g.reshape(nb, B, npg * pool.shape[2], *pool.shape[3:])


def scatter_kv_token(pool: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor, new: torch.Tensor) -> None:
    """Write one token a row (nb, B, KVH, D) at logical position
    ``lengths[b]``, in place (validation helper: the decode tick appends
    inside ``fused_append_attend``)."""
    page = pool.shape[2]
    ln = lengths.long()
    phys = block_table.long()[torch.arange(block_table.shape[0],
                                           device=ln.device), ln // page]
    pool[:, phys, ln % page] = new.to(pool.dtype)


def scatter_kv_prefill(pool: torch.Tensor, blocks: torch.Tensor,
                       seq_kv: torch.Tensor) -> None:
    """Write a whole sequence (nb, S, KVH, D) into its pages ``blocks``
    in place: token i lands in page ``blocks[i // page]``."""
    scatter_kv_chunk(pool, blocks, seq_kv,
                     torch.arange(seq_kv.shape[1], device=pool.device))


# ----------------------------------------------------- sharded page helpers
def _local_ids(ids, s: int, device) -> torch.Tensor:
    """Row ``s`` of a per-shard id grid, as indices on ``device``."""
    return torch.as_tensor(ids[s], device=device).long()


def shard_scatter_kv_chunk(pools, local_pages, seq_kv: torch.Tensor,
                           positions: torch.Tensor, *,
                           active: Optional[int] = None) -> None:
    """Sharded ``scatter_kv_chunk``: ``local_pages`` (n_shards, npg_local)
    holds, in row s column j, the local id of the allocation's logical
    page ``j * active + s``.  Every shard sees the whole chunk's KV (nb,
    L, KVH, D) (a head-sharded shard its head slice) and writes only the
    tokens whose page it owns (page p belongs to shard ``p % active``);
    the rest go to its scratch page.  ``active`` (default: every shard)
    is the live stripe width — shards past it own nothing."""
    rows = head_stripes(pools)
    n_act = active or len(rows[0])
    for t, row in enumerate(rows):
        kv = head_part(seq_kv, t, len(rows), 2)
        for s, pool in enumerate(row):
            dev = pool.device
            page, scratch = pool.shape[2], pool.shape[1] - 1
            pos = positions.to(dev).long()
            pg = pos // page
            phys = torch.where((pg % n_act) == s,
                               _local_ids(local_pages, s, dev)[pg // n_act],
                               torch.full_like(pg, scratch))
            pool[:, phys, pos % page] = kv.to(dev, pool.dtype)


def shard_copy_kv_blocks(dst_pools, src_pools, src_local,
                         dst_local) -> None:
    """Sharded ``copy_kv_blocks``: per-shard (m,) local id lists, each
    pair on one shard (stripe alignment) — a position-local page copy
    (admission between sharded pools of one head layout)."""
    dst_rows, src_rows = head_stripes(dst_pools), head_stripes(src_pools)
    if len(dst_rows) != len(src_rows):
        raise ValueError(f"cannot copy pages between pools of "
                         f"{len(src_rows)} and {len(dst_rows)} head slices")
    for drow, srow in zip(dst_rows, src_rows):
        for s, (dst, src) in enumerate(zip(drow, srow)):
            dst[:, _local_ids(dst_local, s, dst.device)] = src[
                :, _local_ids(src_local, s, src.device)].to(dst.device,
                                                            dst.dtype)


def shard_scatter_kv_blocks(pools, dst_local, pages: torch.Tensor) -> None:
    """Sharded ``scatter_kv_blocks``: ``pages`` (nb, n_shards, m, page,
    KVH, D) grouped per destination shard (host swap-in or promotion
    payloads, or pages regrouped from an unsharded pool); a head-sharded
    pool takes each shard's head slice of them."""
    rows = head_stripes(pools)
    for t, row in enumerate(rows):
        part = head_part(pages, t, len(rows), 4)
        for s, pool in enumerate(row):
            pool[:, _local_ids(dst_local, s, pool.device)] = part[:, s].to(
                pool.device, pool.dtype)


def shard_gather_kv_blocks(pools, local, device) -> torch.Tensor:
    """Sharded ``gather_kv_blocks``: each shard reads its own pages; the
    result (nb, n_shards, m, page, KVH, D) on ``device``, in per-shard
    grouping order (the caller reassembles logical order), with a
    head-sharded pool's slices put back side by side at full width."""
    return torch.cat([
        torch.stack([pool[:, _local_ids(local, s, pool.device)].to(device)
                     for s, pool in enumerate(row)], dim=1)
        for row in head_stripes(pools)], dim=4)


def shard_copy_kv_block_within(pools, src_local, dst_local) -> None:
    """Sharded ``copy_kv_block_within``: per-shard (scalar) local ids —
    the owning shard copies the copy-on-write page, every other shard
    copies its scratch page onto itself."""
    for row in head_stripes(pools):
        for s, pool in enumerate(row):
            pool[:, int(dst_local[s])] = pool[:, int(src_local[s])]


def shard_restripe_kv_blocks(pools, send_local, recv_local) -> None:
    """Cross-shard page migration for a live stripe resize — the one
    operation that moves pages between shards (reference
    ``shard_restripe_kv_blocks``, one ``all_to_all`` over the stripe
    axis).  ``send_local`` is an (N, N, m) grid: row s holds, per
    destination d, the local page ids shard s sends to d (padded with
    its scratch id to m); ``recv_local[d, s]`` the local ids on d that
    take shard s's payload, slot for slot.  Every shard first gathers
    what it sends, grouped by destination; each payload then moves to
    its destination's position (``.to(device)``), and each destination
    writes what it received into its new slots.  Padded slots carry the
    scratch page onto the scratch page.  A head-sharded pool moves each
    stripe's head slice within its own stripe (one TP index)."""
    for row in head_stripes(pools):
        n, m = len(row), send_local.shape[2]
        sent = [pool[:, _local_ids(send_local, s, pool.device).reshape(-1)]
                for s, pool in enumerate(row)]        # (nb, N * m, ...)
        for d, pool in enumerate(row):
            got = torch.cat([sent[s][:, d * m:(d + 1) * m].to(pool.device)
                             for s in range(n)], dim=1)
            pool[:, _local_ids(recv_local, d, pool.device).reshape(-1)] = got


def fused_append_attend(k_pool: torch.Tensor, v_pool: torch.Tensor,
                        append_page: torch.Tensor, append_slot: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """The append half of the decode tick, in place: each row's new K/V
    (B, KVH, D) lands at its (page, slot).  Padded rows aim at the scratch
    page and write bytes nothing reads."""
    pg, sl = append_page.long(), append_slot.long()
    k_pool[pg, sl] = k_new.to(k_pool.dtype)
    v_pool[pg, sl] = v_new.to(v_pool.dtype)


# ----------------------------------------------------------------- K1
def paged_flash_decode_plain(q, k_pool, v_pool, block_tables, lengths, *,
                             window: Optional[int] = None,
                             softmax_scale=None, page_pos=None,
                             k_new=None, v_new=None, append_page=None,
                             append_slot=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: append in place (when given), then attend over
    ``lengths (+1)`` with the masked slots zeroed before any arithmetic;
    ``(o, lse)`` with ``o = 0`` for a row with no valid key."""
    if k_new is not None:
        fused_append_attend(k_pool, v_pool, append_page, append_slot,
                            k_new, v_new)
        lengths = lengths + 1
    B, npg = block_tables.shape
    page = k_pool.shape[1]
    if page_pos is None:
        page_pos = (torch.arange(npg, dtype=torch.int32, device=q.device)
                    * page)[None].expand(B, npg)
    kv_pos = (page_pos[:, :, None] + torch.arange(
        page, dtype=torch.int32, device=q.device)[None, None]
              ).reshape(B, npg * page)
    idx = block_tables.long()
    return _decode_plain(
        q, k_pool[idx].reshape(B, npg * page, *k_pool.shape[2:]),
        v_pool[idx].reshape(B, npg * page, *v_pool.shape[2:]), kv_pos,
        lengths, window, softmax_scale)


def _decode_plain(q, k, v, kv_pos, lengths, window, softmax_scale):
    """One query per row over per-row keys k/v (B, S, KVH, D) at positions
    kv_pos (B, S): keys outside [lengths - window, lengths) are selected
    out before any arithmetic; ``(o, lse)`` with ``o = 0`` for a row with
    no valid key — what K1 and K4 compute."""
    valid = kv_pos < lengths[:, None]
    if window is not None:
        valid &= kv_pos >= (lengths[:, None] - window)
    zero = torch.zeros((), dtype=k.dtype, device=q.device)
    k = torch.where(valid[:, :, None, None], k, zero)
    v = torch.where(valid[:, :, None, None], v, zero)
    out, lse = _ref.attention_ref(
        q[:, None], k, v, q_pos=(lengths - 1)[:, None], kv_pos=kv_pos,
        causal=False, kv_valid=valid, softmax_scale=softmax_scale,
        with_lse=True)
    o, lse = out[:, 0], lse[:, :, 0]
    dead = (lse <= _ref.NEG_INF / 2)[..., None]
    return torch.where(dead, torch.zeros((), dtype=o.dtype,
                                         device=o.device), o), lse


_PD_ARGS = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# blocks the split kernel may launch when every row fills its table: two
# waves of the three blocks that fit each of the H100's 132 SMs (a batch of
# uneven rows leaves many blocks without keys, which exit at once)
_TARGET_BLOCKS = 2 * 3 * 132
# keys per tile of the split kernel (TK in csrc/paged_decode.cu)
_TILE = 64
# GQA groups (H / KVH) the split kernel is built for (by_group in
# csrc/paged_decode.cu); any other group raises on the card
GROUPS = (1, 2, 4, 6, 8, 16)


def plan_splits(npg: int, B: int, KVH: int, page: int) -> Tuple[int, int]:
    """``(splits, pages_per_split)``: each row's ``npg`` table columns cut
    into ``splits`` runs of ``pages_per_split`` pages (the last run may be
    shorter), one block per (run, KV head, row).  Sized from the table
    width, B and KVH alone (no read of the lengths): full rows give at
    most ``_TARGET_BLOCKS`` blocks (at least one run per row), and a run
    holds whole 64-key tiles where the page size divides the tile."""
    npg = max(1, npg)
    pages_per_split = -(-npg // max(1, _TARGET_BLOCKS // (B * KVH)))
    if page < _TILE and _TILE % page == 0:
        unit = _TILE // page
        pages_per_split = -(-pages_per_split // unit) * unit
    pages_per_split = min(pages_per_split, npg)
    return -(-npg // pages_per_split), pages_per_split


def _partials(q: torch.Tensor, npg: int, KVH: int, page: int):
    """Split a row's ``npg`` pages over blocks (flash-decoding) and
    allocate the splits' (m, l, acc) partials the merge kernel reads."""
    B, H, D = q.shape
    splits, pages_per_split = plan_splits(npg, B, KVH, page)
    part_m = torch.empty((B, H, splits), dtype=torch.float32,
                         device=q.device)
    part_acc = torch.empty((B, H, splits, D), dtype=torch.float32,
                           device=q.device)
    return splits, pages_per_split, part_m, torch.empty_like(part_m), \
        part_acc


def _int32_on(t: torch.Tensor, device, n: int, what: str) -> torch.Tensor:
    t = t.to(torch.int32).reshape(n).contiguous()
    if t.device != device:
        raise ValueError(f"paged_flash_decode: {what} must be on {device}")
    return t


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       window: Optional[int] = None,
                       softmax_scale: Optional[float] = None,
                       page_pos: Optional[torch.Tensor] = None,
                       k_new: Optional[torch.Tensor] = None,
                       v_new: Optional[torch.Tensor] = None,
                       append_page: Optional[torch.Tensor] = None,
                       append_slot: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1.  q (B, H, D); pools (n_pages, page, KVH, D); block_tables
    (B, npg) int32; lengths (B,) int32 (EXCLUDING the new token when
    ``k_new`` is given).  Returns o (B, H, D) and lse (B, H) fp32; with
    ``k_new`` the pools are written in place first."""
    if not q.is_cuda:
        return paged_flash_decode_plain(
            q, k_pool, v_pool, block_tables, lengths, window=window,
            softmax_scale=softmax_scale, page_pos=page_pos, k_new=k_new,
            v_new=v_new, append_page=append_page, append_slot=append_slot)
    B, H, D = q.shape
    _, page, KVH, Dk = k_pool.shape
    if (Dk != D or v_pool.shape != k_pool.shape or H % KVH
            or block_tables.dim() != 2 or block_tables.shape[0] != B):
        raise ValueError(
            f"paged_flash_decode: shapes q {tuple(q.shape)} pool "
            f"{tuple(k_pool.shape)} table {tuple(block_tables.shape)}")
    if H // KVH not in GROUPS:
        raise ValueError(f"paged_flash_decode: GQA group {H // KVH} "
                         f"not in {GROUPS}")
    append = k_new is not None
    tensors = (q, k_pool, v_pool) + ((k_new, v_new) if append else ())
    _check("paged_flash_decode", *tensors)
    if append and (k_new.shape != (B, KVH, D) or v_new.shape != k_new.shape):
        raise ValueError("paged_flash_decode: k_new/v_new must be "
                         f"({B}, {KVH}, {D})")
    dev = q.device
    npg = block_tables.shape[1]
    bt = _int32_on(block_tables, dev, B * npg, "block_tables")
    ln = _int32_on(lengths, dev, B, "lengths")
    pp = (None if page_pos is None
          else _int32_on(page_pos, dev, B * npg, "page_pos"))
    ap = _int32_on(append_page, dev, B, "append_page") if append else None
    asl = _int32_on(append_slot, dev, B, "append_slot") if append else None
    splits, pages_per_split, part_m, part_l, part_acc = _partials(
        q, npg, KVH, page)
    o = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _build.library("paged_decode").paged_decode_fwd
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _PD_ARGS, ctypes.c_int
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            bt.data_ptr(), ln.data_ptr(), ptr(pp), ptr(k_new), ptr(v_new),
            ptr(ap), ptr(asl), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, KVH, D, npg, page, splits, pages_per_split,
            -1 if window is None else int(window), float(scale),
            _DTYPES[q.dtype], _build.stream_ptr(dev))
    _build.check(rc, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return o, lse


paged_flash_decode.launches = 0


# ----------------------------------------------------------------- K4
def flash_decode_plain(q, k_cache, v_cache, lengths, *,
                       window: Optional[int] = None, softmax_scale=None,
                       kv_offset: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: ``(o, lse)``."""
    B, S = k_cache.shape[:2]
    kv_pos = kv_offset + torch.arange(S, dtype=torch.int32, device=q.device)
    return _decode_plain(q, k_cache, v_cache, kv_pos[None].expand(B, S),
                         lengths, window, softmax_scale)


_DD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# keys per virtual page of a dense row (the split granularity)
_DENSE_PAGE = 64


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 window: Optional[int] = None,
                 softmax_scale: Optional[float] = None,
                 kv_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4.  q (B, H, D); caches (B, S, KVH, D); lengths (B,) int32.
    Returns o (B, H, D) and lse (B, H) fp32."""
    if not q.is_cuda:
        return flash_decode_plain(q, k_cache, v_cache, lengths,
                                  window=window, softmax_scale=softmax_scale,
                                  kv_offset=kv_offset)
    B, H, D = q.shape
    _, S, KVH, Dk = k_cache.shape
    if (Dk != D or v_cache.shape != k_cache.shape or H % KVH
            or k_cache.shape[0] != B):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)}")
    if H // KVH not in GROUPS:
        raise ValueError(f"flash_decode: GQA group {H // KVH} not in "
                         f"{GROUPS}")
    _check("flash_decode", q, k_cache, v_cache)
    dev = q.device
    ln = lengths.to(torch.int32).reshape(B).contiguous()
    if ln.device != dev:
        raise ValueError(f"flash_decode: lengths must be on {dev}")
    splits, pages_per_split, part_m, part_l, part_acc = _partials(
        q, max(1, -(-S // _DENSE_PAGE)), KVH, _DENSE_PAGE)
    o = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    fn = _build.library("paged_decode").dense_decode_fwd
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _DD_ARGS, ctypes.c_int
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            ln.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, KVH, D, S, int(kv_offset), _DENSE_PAGE, splits,
            pages_per_split, -1 if window is None else int(window),
            float(scale), _DTYPES[q.dtype], _build.stream_ptr(dev))
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return o, lse


flash_decode.launches = 0
