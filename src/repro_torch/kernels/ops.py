"""Dispatch between the hand-written CUDA kernels and the plain versions.

A CUDA tensor goes to its kernel (which raises if it cannot run); a CPU
tensor goes to the plain PyTorch version in ``ref.py``, the same functions
the reference runs with ``impl="ref"``.  ``impl="ref"`` picks the plain
version on any device (the comparison runs of ``chip_smoke.py``);
``impl="ref_blocked"`` does too, with ``attention`` one block of queries
at a time (``ref.attention_ref_blocked``, the plain path of a long
prefill, whose whole score matrix would not fit; reference
``ops.py:39``) and every other function as under ``"ref"``.  Nothing
falls back from a kernel to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention, needs_grad,
                                                 paged_flash_prefill)
from repro_torch.kernels.flash_decode import (flash_decode,
                                              fused_append_attend,
                                              paged_flash_decode)
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan, ssd_scan_plain

IMPLS = (None, "ref", "ref_blocked")
# position of a dead key: past every query, so the causal mask retires it
INT32_MAX = 2 ** 31 - 1


def use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    """True when ``x`` should go through the CUDA kernel."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl is None and x.is_cuda


def attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
              window: Optional[int] = None, softmax_scale=None,
              with_lse: bool = False, impl: Optional[str] = None):
    if impl == "ref_blocked":
        return _ref.attention_ref_blocked(
            q, k, v, q_pos, kv_pos, causal=causal, window=window,
            softmax_scale=softmax_scale, with_lse=with_lse)
    if not use_kernel(q, impl):
        return _ref.attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                  window=window, softmax_scale=softmax_scale,
                                  with_lse=with_lse)
    if needs_grad(q, k, v):
        out, lse = FlashAttentionFn.apply(q, k, v, q_pos, kv_pos, causal,
                                          window, softmax_scale)
    else:
        out, lse = flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window, softmax_scale=softmax_scale)
    return (out, lse) if with_lse else out


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int] = None, softmax_scale=None,
                     with_lse: bool = False, kv_offset: int = 0,
                     impl: Optional[str] = None):
    """Dense-cache decode: one query token per row.  q (B, H, D); caches
    (B, S, KVH, D); lengths (B,) valid keys counted from ``kv_offset``."""
    if not use_kernel(q, impl):
        return _ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                         window=window,
                                         softmax_scale=softmax_scale,
                                         with_lse=with_lse,
                                         kv_offset=kv_offset)
    o, lse = flash_decode(q, k_cache, v_cache, lengths, window=window,
                          softmax_scale=softmax_scale, kv_offset=kv_offset)
    return (o, lse) if with_lse else o


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           window: Optional[int] = None, softmax_scale=None,
                           with_lse: bool = False, impl: Optional[str] = None,
                           page_pos=None, k_new=None, v_new=None,
                           append_page=None, append_slot=None):
    """Block-table decode attention: one query token per row against a
    paged pool.  q (B, H, D); pools (n_pages, page, KVH, D); block_tables
    (B, npg) int32; lengths (B,).

    Fused append+attend: with ``k_new``/``v_new`` (B, KVH, D) and
    ``append_page``/``append_slot`` (B,), the new token's K/V is written
    into the pools in place and the row attends over ``lengths + 1``; the
    return value is then ``(o[, lse], k_pool, v_pool)`` — the same pool
    tensors, so callers holding them see the write.

    A sequence-parallel sharded pool (3-dim block_tables (n_shards, B,
    npg_local) over per-shard pools) is read through its logical-order
    view (``ref.sharded_pool_view``): K4 over that view on the card, the
    plain decode elsewhere.  The engine's sharded decode does not come
    here: it runs the split-KV island
    (core/ring_attention.sharded_paged_decode), whose per-shard partials
    call this function with shard-local 2-dim tables and ``page_pos``."""
    kernel = use_kernel(q, impl)
    if block_tables.dim() == 3:
        if k_new is not None or page_pos is not None:
            raise ValueError("the fused append and page_pos need a "
                             "shard-local 2-dim table")
        if not kernel:
            return _ref.paged_decode_attention_ref(
                q, k_pool, v_pool, block_tables, lengths, window=window,
                softmax_scale=softmax_scale, with_lse=with_lse)
        o, lse = flash_decode(
            q, _ref.sharded_pool_view(k_pool, block_tables),
            _ref.sharded_pool_view(v_pool, block_tables), lengths,
            window=window, softmax_scale=softmax_scale)
        return (o, lse) if with_lse else o
    if k_new is not None:
        if kernel:
            o, lse = paged_flash_decode(
                q, k_pool, v_pool, block_tables, lengths, window=window,
                softmax_scale=softmax_scale, page_pos=page_pos, k_new=k_new,
                v_new=v_new, append_page=append_page,
                append_slot=append_slot)
        else:
            fused_append_attend(k_pool, v_pool, append_page, append_slot,
                                k_new, v_new)
            o, lse = _ref.paged_decode_attention_ref(
                q, k_pool, v_pool, block_tables, lengths + 1, window=window,
                softmax_scale=softmax_scale, with_lse=True,
                page_pos=page_pos)
        return ((o, lse, k_pool, v_pool) if with_lse
                else (o, k_pool, v_pool))
    if kernel:
        o, lse = paged_flash_decode(q, k_pool, v_pool, block_tables,
                                    lengths, window=window,
                                    softmax_scale=softmax_scale,
                                    page_pos=page_pos)
        return (o, lse) if with_lse else o
    return _ref.paged_decode_attention_ref(
        q, k_pool, v_pool, block_tables, lengths, window=window,
        softmax_scale=softmax_scale, with_lse=with_lse, page_pos=page_pos)


def paged_prefill_attention(q, k_new, v_new, q_pos, kv_pos_new,
                            k_pool, v_pool, block_tables, hist_len, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            softmax_scale=None, impl: Optional[str] = None):
    """Prefill-chunk attention over [history pages ++ own chunk KV].

    On the card this is K2 over the history pages, K3 over the chunk's own
    KV, and ``merge_partials`` by LSE — numerically the single-softmax
    result.  Elsewhere the gather version ``ref.paged_prefill_attention_ref``
    runs, as in the reference.

    A sequence-parallel sharded pool (3-dim block_tables) is the fallback
    for chunks whose length does not divide over the ring: on the card
    the logical-order history slab is gathered and K3 runs once over
    [slab ++ chunk] with their positions, the slab's slots at or past
    ``hist_len`` pushed to INT32_MAX, where the causal mask retires them
    (so this branch is causal only)."""
    if not use_kernel(q, impl):
        return _ref.paged_prefill_attention_ref(
            q, k_new, v_new, q_pos, kv_pos_new, k_pool, v_pool,
            block_tables, hist_len, causal=causal, window=window,
            softmax_scale=softmax_scale)
    if block_tables.dim() == 3:
        if not causal:
            raise ValueError("paged_prefill_attention over a sharded pool "
                             "is causal only")
        B, Sq = q.shape[:2]
        hk = _ref.sharded_pool_view(k_pool, block_tables)
        hv = _ref.sharded_pool_view(v_pool, block_tables)
        S_h = hk.shape[1]
        hpos = torch.arange(S_h, dtype=torch.int32, device=q.device)[None]
        hpos = torch.where(hpos < hist_len[:, None].to(torch.int32), hpos,
                           torch.full_like(hpos, INT32_MAX))
        kv_pos = torch.cat([hpos.expand(B, S_h),
                            _ref._broadcast_pos(kv_pos_new, B)], dim=1)
        out, _ = flash_attention(
            q, torch.cat([hk.to(k_new.dtype), k_new], dim=1),
            torch.cat([hv.to(v_new.dtype), v_new], dim=1), q_pos,
            kv_pos.to(torch.int32), causal=True, window=window,
            softmax_scale=softmax_scale)
        return out
    o_h, lse_h = paged_flash_prefill(
        q, k_pool, v_pool, block_tables, hist_len, q_pos, causal=causal,
        window=window, softmax_scale=softmax_scale)
    o_s, lse_s = flash_attention(
        q, k_new, v_new, q_pos, kv_pos_new, causal=causal, window=window,
        softmax_scale=softmax_scale)
    out, _ = _ref.merge_partials([o_h, o_s], [lse_h, lse_s])
    return out


def ssd(x, dt, A, Bm, Cm, *, h0=None, chunk: int = 128,
        impl: Optional[str] = None):
    """Mamba-2 chunked SSD scan: ``(y, h_final)``.  On the card K5 masks
    the ragged last chunk itself; the plain version pads it with dt = 0
    (the recurrence's identity), as the reference does."""
    if not use_kernel(x, impl):
        return ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
    if needs_grad(x, dt, A, Bm, Cm, h0):
        return SSDScanFn.apply(x, dt, A, Bm, Cm, h0, chunk)
    return ssd_scan(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)


def ssd_decode(x, dt, A, Bm, Cm, h, out=None):
    """One-token SSD state update, O(1) per token: plain PyTorch on every
    device, as in the reference (which has no kernel for it); ``out``
    takes the new state."""
    return _ref.ssd_decode_ref(x, dt, A, Bm, Cm, h, out=out)


merge_partials = _ref.merge_partials
