"""Attention block: projections + RoPE + mode-dispatched attention core.

Single-device branches of the reference (models/attention.py):
  train / prefill — causal attention over the chunk (K3 on the card), or,
      with a paged history, over [history pages ++ own chunk] (K2 + K3 +
      LSE merge on the card);
  decode — one token per row: the fused paged append+attend tick (K1 on
      the card) over {"k","v","block_table"} pools, or dense decode (K4 on
      the card) over {"k","v"} buffers; with a sliding window, dense
      decode may keep a ring buffer of the last S_max <= window tokens
      (``ctx.ring_cache``) or attend over a window + 8 slice of a buffer
      of at least 4 windows (``ctx.window_slice``);
  encode — an encoder's self-attention: the train branch with no cache
      (Whisper's encoder, non-causal, K3 on the card).
On a mesh (reference models/attention.py:98-175, 250-320): a chunk whose
length divides over ``ctx.sp_axis`` runs ring attention
(core/ring_attention, K3 per position and ring step) — over its own KV
and any dense history, or, with a striped paged history (3-dim tables),
``ring_paged_prefill`` with each shard's history pages rotating through
the ring; other chunks over a striped history take the gather fallback
of ``ops.paged_prefill_attention``.  A striped paged decode cache runs
the split-KV island ``sharded_paged_decode`` (K1 per shard, the append
on the owning shard).  With ``ctx.tp_axis`` (TP x SP, reference
``_qkv_specs``) the query heads shard over it where they divide it, and
the KV heads and the pools too where KVH divides it; each TP index runs
the island on its heads (K3 / K1 per SP and TP position).  An unsharded
pool under an active split or ring axis raises ``ValueError``: the
layouts must agree.  Dense decode under ``ctx.kv_split_axis`` takes a
cache laid out as per-position sequence shards (lists,
``core.cdsp.shard_dense_caches``): ``split_kv_decode`` writes the new
token into the owning shard and runs K4 per shard with an LSE merge; the
window-slice branch writes with ``sharded_cache_update`` and attends
over the window's keys gathered from the shards, the ring-buffer branch
over the shards' live slots.  A prefill stored in zigzag order runs the
causal-skip ring under ``ctx.zigzag_skip`` (reference
attention.py:318).
``cross_attention`` is the encoder-decoder's cross attention over the
encoder's K/V, with the ``x_``-prefixed weights: "cross" in prefill and
train (K3 on the card), "cross_decode" in a decode tick (K4 on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.ring_attention import (ring_attention,
                                             ring_paged_prefill,
                                             sharded_cache_update,
                                             sharded_paged_decode,
                                             split_kv_decode)
from repro_torch.launch.mesh import to
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.sharding import ExecContext


def _proj(x: torch.Tensor, p: dict, cfg: ModelConfig, name: str,
          heads: int, prefix: str) -> torch.Tensor:
    """One of the q/k/v projections: (B, S, heads, head_dim)."""
    y = x @ p[f"{prefix}w{name}"]
    if cfg.qkv_bias:
        y = y + p[f"{prefix}b{name}"]
    return y.reshape(x.shape[0], x.shape[1], heads, cfg.head_dim_)


def qkv_proj(x: torch.Tensor, p: dict, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (_proj(x, p, cfg, "q", cfg.padded_heads, ""),
            *kv_proj(x, p, cfg))


def kv_proj(x: torch.Tensor, p: dict, cfg: ModelConfig, prefix: str = ""
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k and v alone; with ``prefix="x_"`` the cross KV of an encoder's
    output (the reference takes them from its ``qkv_proj`` and drops q)."""
    return (_proj(x, p, cfg, "k", cfg.n_kv_heads, prefix),
            _proj(x, p, cfg, "v", cfg.n_kv_heads, prefix))


def out_proj(o: torch.Tensor, p: dict, prefix: str = "") -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p[prefix + "wo"]


def _head_axes(cfg: ModelConfig, ctx: ExecContext):
    """(query head axis, KV head axis) of the islands: ``ctx.tp_axis``
    for each head count that divides it (reference ``_qkv_specs``).  The
    KV axis is the pools' head axis (``ExecContext.pool_head_axis``), and
    counts only with the query heads on it."""
    h_ax = ctx.shardable(cfg.padded_heads, ctx.tp_axis)
    kv_ax = ctx.pool_head_axis(cfg.n_kv_heads)
    return h_ax, kv_ax if h_ax is not None else None


def cross_attention(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    ctx: ExecContext, positions: torch.Tensor, mode: str,
                    cache: dict) -> torch.Tensor:
    """The decoder's queries over the encoder's cross KV ``cache``
    {"k","v"} (B, S_x, KVH, D), every key valid, with the layer's ``x_``
    weights: "cross" through ``ops.attention`` with key positions
    0..S_x-1, non-causal (reference attention.py:241-247); "cross_decode"
    (x (B, 1, d)) through ``ops.decode_attention`` with lengths S_x
    (reference attention.py:230-237).  Only q is projected from x (the
    reference's k/v of x go unused)."""
    prefix = "x_"
    B = x.shape[0]
    q = apply_rope(_proj(x, p, cfg, "q", cfg.padded_heads, prefix),
                   positions, cfg)
    S_x = cache["k"].shape[1]
    if mode == "cross_decode":
        lengths = torch.full((B,), S_x, dtype=torch.int32, device=x.device)
        o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths,
                                 impl=ctx.impl)
        return out_proj(o[:, None], p, prefix)
    pos2d = positions[0] if positions.dim() == 3 else positions
    kv_pos = torch.arange(S_x, dtype=torch.int32, device=x.device)
    o = ops.attention(q, cache["k"], cache["v"], q_pos=pos2d, kv_pos=kv_pos,
                      causal=False, impl=ctx.impl)
    return out_proj(o, p, prefix)


def attention_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    ctx: ExecContext, positions: torch.Tensor, mode: str,
                    cache: Optional[dict] = None,
                    cache_len: Optional[torch.Tensor] = None,
                    window: Optional[int] = None, causal: bool = True,
                    history: Optional[dict] = None):
    """Returns (out, new_cache_or_None).

    positions: (B, S) int32.  decode: x (B, 1, d), cache_len (B,), cache
    either paged {"k","v","block_table"} (pools (n_pages, page, KVH, D),
    table (B, npg)) — written in place by the fused tick — or dense
    {"k","v"} (B, S_max, KVH, D).  A *sharded* paged cache has per-shard
    pool lists (blocks_per_shard + 1, page, KVH, D) and tables (n_shards,
    B, npg_local); the owning shard's pool is written in place.  history
    (CDSP chunked prefill): paged {"k_pool","v_pool","block_table","len"}
    (pools and tables sharded likewise under ring attention), or dense
    {"k","v","pos"}."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(x, p, cfg)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    pos2d = positions[0] if positions.dim() == 3 else positions
    split_n = (ctx.axis_size(ctx.kv_split_axis)
               if ctx.kv_split_axis is not None else 1)

    if mode == "decode" and cache is not None and "block_table" in cache:
        assert cache_len is not None
        bt = cache["block_table"]
        if bt.dim() == 3:
            # split-KV paged decode island: the append lands on the shard
            # owning the target page (fused with its attend), each shard
            # attends its own pages, partials merge by LSE
            if ctx.kv_split_axis is None or ctx.mesh is None:
                raise ValueError("a sharded paged cache needs "
                                 "ctx.kv_split_axis and a mesh")
            # a head-sharded pool (KVH dividing the TP axis) runs the
            # island per TP index on its heads; a pool replicated over TP
            # runs it on every head (reference attention.py:120-130)
            o, k_pool, v_pool = sharded_paged_decode(
                q[:, 0], cache["k"], cache["v"], bt, cache_len,
                mesh=ctx.mesh, split_axis=ctx.kv_split_axis,
                head_axis=_head_axes(cfg, ctx)[1], window=window,
                impl=ctx.impl, k_new=k[:, 0], v_new=v[:, 0],
                active_shards=ctx.active_pool_shards)
            return out_proj(o[:, None], p), {"k": k_pool, "v": v_pool,
                                             "block_table": bt}
        if split_n > 1:
            raise ValueError(
                "paged decode with ExecContext.kv_split_axis="
                f"{ctx.kv_split_axis!r} needs the SHARDED pool layout "
                "(per-shard pools, block_table (n_shards, B, npg_local) — "
                "build the PagedKVCache with kv_shards > 1), got an "
                "unsharded 2-dim block table.  Either hand over the "
                "sharded layout or run with ctx.with_(kv_split_axis=None).")
        page = cache["k"].shape[1]
        rows = torch.arange(B, device=bt.device)
        o, k_pool, v_pool = ops.paged_decode_attention(
            q[:, 0], cache["k"], cache["v"], bt, cache_len, window=window,
            impl=ctx.impl, k_new=k[:, 0], v_new=v[:, 0],
            append_page=bt[rows, (cache_len // page).long()],
            append_slot=cache_len % page)
        return out_proj(o[:, None], p), {"k": k_pool, "v": v_pool,
                                         "block_table": bt}

    if mode == "decode":
        assert cache is not None and cache_len is not None
        if isinstance(cache["k"], (list, tuple)) or split_n > 1:
            return _split_dense_decode(q, k, v, p, cfg, ctx, cache,
                                       cache_len, window)
        rows = torch.arange(B, device=x.device)
        S_max = cache["k"].shape[1]
        ring = ctx.ring_cache and window is not None and S_max <= window
        # the new token's slot: the ring buffer keeps the last S_max tokens
        slot = (cache_len % S_max if ring else cache_len).long()
        k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
        k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
        k_att, v_att, lengths, win = k_cache, v_cache, cache_len + 1, window
        if ring:
            # attention does not depend on the order of the keys, so the
            # slots' order is irrelevant once the buffer wraps
            lengths, win = torch.clamp(lengths, max=S_max), None
        elif ctx.window_slice and window is not None \
                and S_max >= 4 * window:
            # attend over a slice of window + 8 keys that holds the
            # window, not over the whole buffer
            wbuf = window + 8
            start = torch.clamp(cache_len - (wbuf - 1), 0, S_max - wbuf)
            idx = (start[:, None] + torch.arange(
                wbuf, device=x.device)[None]).long()
            k_att, v_att = (k_cache[rows[:, None], idx],
                            v_cache[rows[:, None], idx])
            lengths = lengths - start
        o = ops.decode_attention(q[:, 0], k_att, v_att, lengths, window=win,
                                 impl=ctx.impl)
        return out_proj(o[:, None], p), {"k": k_cache, "v": v_cache}

    if mode not in ("train", "prefill", "encode"):
        raise NotImplementedError(f"attention mode {mode!r}")
    k_self, v_self = k, v
    new_cache = {"k": k_self, "v": v_self} if mode == "prefill" else None
    sp_n = (ctx.axis_size(ctx.sp_axis)
            if ctx.sp_axis is not None and ctx.mesh is not None else 1)
    if history is not None and "block_table" in history:
        bt = history["block_table"]
        if bt.dim() == 2 and sp_n > 1:
            raise ValueError(
                "paged cross-chunk history under ring attention "
                f"(ExecContext.sp_axis={ctx.sp_axis!r}) needs the SHARDED "
                "pool layout (PagedKVCache with kv_shards > 1; block_table "
                "(n_shards, B, npg_local)), got an unsharded 2-dim block "
                "table.  Either hand over the sharded layout or run with "
                "ctx.with_(sp_axis=None).")
        if bt.dim() == 3 and sp_n > 1 and S % sp_n == 0:
            # the chunk's queries/KV ride the ring and each shard's
            # history pages rotate along with them
            h_ax, kv_ax = _head_axes(cfg, ctx)
            o = ring_paged_prefill(
                q, k, v, pos2d, pos2d, history["k_pool"], history["v_pool"],
                bt, history["len"], mesh=ctx.mesh, sp_axis=ctx.sp_axis,
                head_axis=h_ax, kv_head_axis=kv_ax, causal=causal,
                window=window, impl=ctx.impl,
                active_shards=ctx.active_pool_shards)
        else:
            # one position, or a chunk that does not divide over the
            # ring: the gather fallback reads a striped pool through its
            # logical-order view, over the live stripe's rows only
            if bt.dim() == 3 and ctx.active_pool_shards:
                bt = bt[:min(ctx.active_pool_shards, bt.shape[0])]
            o = ops.paged_prefill_attention(
                q, k, v, pos2d, pos2d, history["k_pool"], history["v_pool"],
                bt, history["len"], causal=causal, window=window,
                impl=ctx.impl)
        return out_proj(o, p), new_cache
    kv_pos = pos2d
    if history is not None:
        k = torch.cat([history["k"].to(k.dtype), k], dim=1)
        v = torch.cat([history["v"].to(v.dtype), v], dim=1)
        hpos = history["pos"]
        if hpos.dim() == 1:
            hpos = hpos[None].expand(B, hpos.shape[0])
        kv_pos = torch.cat([hpos, pos2d], dim=1)
    if sp_n > 1 and S % sp_n == 0 and k.shape[1] % sp_n == 0:
        h_ax, kv_ax = _head_axes(cfg, ctx)
        o = ring_attention(q, k, v, pos2d, kv_pos, mesh=ctx.mesh,
                           sp_axis=ctx.sp_axis, head_axis=h_ax,
                           kv_head_axis=kv_ax, causal=causal, window=window,
                           impl=ctx.impl,
                           zigzag_skip=ctx.zigzag_skip and history is None)
    else:
        o = ops.attention(q, k, v, pos2d, kv_pos, causal=causal,
                          window=window, impl=ctx.impl)
    return out_proj(o, p), new_cache


def _window_keys(shards, idx: torch.Tensor, device) -> torch.Tensor:
    """Keys ``idx`` (B, W) global positions of a sequence-sharded cache
    (list of (B, S_loc, KVH, D)), gathered from the shards that hold them
    onto ``device``: (B, W, KVH, D)."""
    s_loc = shards[0].shape[1]
    out = None
    for i, c in enumerate(shards):
        loc = to(idx, c.device) - i * s_loc
        mine = (loc >= 0) & (loc < s_loc)
        rows = torch.arange(idx.shape[0], device=c.device)[:, None]
        part = c[rows, loc.clamp(0, s_loc - 1)] * mine[..., None, None]
        part = to(part, device)
        out = part if out is None else out + part
    return out


def _split_dense_decode(q, k, v, p, cfg: ModelConfig, ctx: ExecContext,
                        cache: dict, cache_len, window):
    """Dense decode over a cache laid out as per-position sequence shards
    on ``ctx.kv_split_axis`` (reference attention.py:182-221).  The query
    heads stay whole on every shard, as the reference's island takes them
    (no TP slicing).  The shards are written in place and handed back."""
    if not isinstance(cache["k"], (list, tuple)) \
            or ctx.kv_split_axis is None or ctx.mesh is None:
        raise ValueError(
            "dense decode under ExecContext.kv_split_axis="
            f"{ctx.kv_split_axis!r} needs the cache as per-position "
            "sequence shards (core.cdsp.shard_dense_caches), and a shard "
            "list needs the split axis and a mesh")
    n = ctx.axis_size(ctx.kv_split_axis)
    if len(cache["k"]) != n:
        raise ValueError(f"a dense cache of {len(cache['k'])} shards over a "
                         f"split axis of {n} positions")
    qd, kn, vn = q[:, 0], k[:, 0], v[:, 0]
    S_max = n * cache["k"][0].shape[1]
    kw = dict(mesh=ctx.mesh, split_axis=ctx.kv_split_axis)
    if ctx.ring_cache and window is not None and S_max <= window:
        # the ring buffer's slot, then every live slot of the shards
        sharded_cache_update(cache["k"], cache["v"], kn, vn,
                             cache_len % S_max, **kw)
        o, _, _ = split_kv_decode(qd, cache["k"], cache["v"],
                                  torch.clamp(cache_len + 1, max=S_max),
                                  impl=ctx.impl, **kw)
    elif ctx.window_slice and window is not None and S_max >= 4 * window:
        # persist the new KV in its shard, attend over the window's keys
        sharded_cache_update(cache["k"], cache["v"], kn, vn, cache_len,
                             **kw)
        wbuf = window + 8
        start = torch.clamp(cache_len - (wbuf - 1), 0, S_max - wbuf)
        idx = (start[:, None] + torch.arange(
            wbuf, device=q.device)[None]).long()
        o = ops.decode_attention(
            qd, _window_keys(cache["k"], idx, q.device),
            _window_keys(cache["v"], idx, q.device),
            cache_len + 1 - start, window=window, impl=ctx.impl)
    else:
        o, _, _ = split_kv_decode(qd, cache["k"], cache["v"], cache_len,
                                  window=window, impl=ctx.impl, k_new=kn,
                                  v_new=vn, **kw)
    return out_proj(o[:, None], p), {"k": cache["k"], "v": cache["v"]}
