"""Dispatch between the hand-written CUDA kernels and the plain versions.

A CUDA tensor goes to its kernel (which raises if it cannot run); a CPU
tensor goes to the plain PyTorch version in ``ref.py``, the same functions
the reference runs with ``impl="ref"``.  ``impl="ref"`` picks the plain
version on any device (the comparison runs of ``chip_smoke.py``).  Nothing
falls back from a kernel to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 paged_flash_prefill)
from repro_torch.kernels.flash_decode import (fused_append_attend,
                                              paged_flash_decode)

IMPLS = (None, "ref")


def use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    """True when ``x`` should go through the CUDA kernel."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl is None and x.is_cuda


def attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
              window: Optional[int] = None, softmax_scale=None,
              with_lse: bool = False, impl: Optional[str] = None):
    if not use_kernel(q, impl):
        return _ref.attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                  window=window, softmax_scale=softmax_scale,
                                  with_lse=with_lse)
    out, lse = flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, softmax_scale=softmax_scale)
    return (out, lse) if with_lse else out


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int] = None, softmax_scale=None,
                     with_lse: bool = False, kv_offset: int = 0,
                     impl: Optional[str] = None):
    """Dense-cache decode.  Its kernel (K4) is not ported yet, so only the
    plain version runs, and only on the CPU or when asked for by name."""
    if use_kernel(q, impl):
        raise NotImplementedError(
            "dense-cache decode has no CUDA kernel yet; serve through the "
            "paged pools, or pass impl='ref'")
    return _ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                     window=window,
                                     softmax_scale=softmax_scale,
                                     with_lse=with_lse, kv_offset=kv_offset)


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
    tensors, so callers holding them see the write."""
    kernel = use_kernel(q, impl)
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
    runs, as in the reference."""
    if not use_kernel(q, impl):
        return _ref.paged_prefill_attention_ref(
            q, k_new, v_new, q_pos, kv_pos_new, k_pool, v_pool,
            block_tables, hist_len, causal=causal, window=window,
            softmax_scale=softmax_scale)
    o_h, lse_h = paged_flash_prefill(
        q, k_pool, v_pool, block_tables, hist_len, q_pos, causal=causal,
        window=window, softmax_scale=softmax_scale)
    o_s, lse_s = flash_attention(
        q, k_new, v_new, q_pos, kv_pos_new, causal=causal, window=window,
        softmax_scale=softmax_scale)
    out, _ = _ref.merge_partials([o_h, o_s], [lse_h, lse_s])
    return out


merge_partials = _ref.merge_partials
