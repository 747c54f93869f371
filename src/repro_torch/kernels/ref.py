"""Plain PyTorch versions of the attention functions the kernels compute.

These mirror ``repro.kernels.ref`` operation for operation (fp32 math,
``NEG_INF = -1e30`` masking) and are the execution path wherever a tensor
lies on the CPU; the CUDA kernels in this package are held to them on the
card (``chip_smoke.py``).

Position-array masking: attention takes explicit integer position arrays
for the query and key sides, and causality is ``kv_pos <= q_pos``.  That
one rule expresses plain causal prefill, chunked (CDSP) prefill against
paged history, sliding windows and decode-with-cache.

A fully masked query row keeps the reference's semantics: its logits are
all ``NEG_INF``, so ``lse`` comes out as ``-1e30`` (to fp32 precision) and
merging it with another partial gives it zero weight.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

NEG_INF = -1e30


def _broadcast_pos(pos: torch.Tensor, batch: int) -> torch.Tensor:
    if pos.dim() == 1:
        pos = pos[None]
    return pos.expand(batch, pos.shape[-1])


def attention_ref(
    q: torch.Tensor,                     # (B, Sq, H, D)
    k: torch.Tensor,                     # (B, Sk, KVH, D)
    v: torch.Tensor,                     # (B, Sk, KVH, D)
    q_pos: torch.Tensor,                 # (Sq,) or (B, Sq) int32
    kv_pos: torch.Tensor,                # (Sk,) or (B, Sk) int32
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,   # (B, Sk) bool
    softmax_scale: Optional[float] = None,
    with_lse: bool = False,
):
    """Grouped-query attention with position-array masking.

    Returns out (B, Sq, H, D); with ``with_lse`` also lse (B, H, Sq)."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    assert H % KVH == 0, (H, KVH)
    group = H // KVH
    scale = softmax_scale if softmax_scale is not None else D ** -0.5

    q_pos = _broadcast_pos(q_pos, B)
    kv_pos = _broadcast_pos(kv_pos, B)

    qf = q.float().reshape(B, Sq, KVH, group, D)
    kf = k.float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale

    mask = torch.ones((B, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        mask &= (q_pos[:, :, None] - kv_pos[:, None, :]) < window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))

    m = logits.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    unnorm = torch.exp(logits - m)
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / denom.clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if not with_lse:
        return out
    lse = m[..., 0] + torch.log(denom[..., 0].clamp_min(1e-30))
    return out, lse.reshape(B, H, Sq)


def merge_partials(outs: List[torch.Tensor], lses: List[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge partial attention results (o_i, lse_i) over disjoint KV sets.

    outs[i]: (B, Sq, H, D), softmax-normalised within part i;
    lses[i]: (B, H, Sq)."""
    lse = torch.logsumexp(torch.stack(lses), dim=0)             # (B, H, Sq)
    out = 0.0
    for o_i, l_i in zip(outs, lses):
        w = torch.exp(l_i - lse)
        out = out + o_i.float() * w.transpose(1, 2)[..., None]
    return out.to(outs[0].dtype), lse


def decode_attention_ref(
    q: torch.Tensor,                     # (B, H, D) — one new token per row
    k_cache: torch.Tensor,               # (B, S, KVH, D)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,               # (B,) int32 valid cache length
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    with_lse: bool = False,
    kv_offset: int = 0,
):
    """Single-token decode attention over a dense KV cache."""
    B, S, KVH, D = k_cache.shape
    kv_pos = kv_offset + torch.arange(S, dtype=torch.int32,
                                      device=q.device)
    kv_valid = kv_pos[None, :] < lengths[:, None]
    if window is not None:
        kv_valid &= kv_pos[None, :] >= (lengths[:, None] - window)
    res = attention_ref(q[:, None], k_cache, v_cache,
                        q_pos=(lengths - 1)[:, None],
                        kv_pos=kv_pos[None].expand(B, S),
                        causal=False, kv_valid=kv_valid,
                        softmax_scale=softmax_scale, with_lse=with_lse)
    if with_lse:
        out, lse = res
        return out[:, 0], lse[:, :, 0]
    return res[:, 0]


def paged_decode_attention_ref(
    q: torch.Tensor,                     # (B, H, D)
    k_pool: torch.Tensor,                # (n_pages, page, KVH, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,          # (B, pages_per_seq) int32
    lengths: torch.Tensor,               # (B,) int32
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
    with_lse: bool = False,
    page_pos: Optional[torch.Tensor] = None,   # (B, pages_per_seq) int32
):
    """Single-token decode attention off a paged pool: gather the table
    into a dense per-row view sized to the table width, then attend.

    ``page_pos`` gives each table column's first-token logical position
    (default: flat table order); length and window masks follow it."""
    if block_tables.dim() != 2:
        raise ValueError("the port serves 2-dim (unsharded) block tables")
    B, npg = block_tables.shape
    page = k_pool.shape[1]
    idx = block_tables.long()
    k = k_pool[idx].reshape(B, npg * page, *k_pool.shape[2:])
    v = v_pool[idx].reshape(B, npg * page, *v_pool.shape[2:])
    if page_pos is None:
        return decode_attention_ref(q, k, v, lengths, window=window,
                                    softmax_scale=softmax_scale,
                                    with_lse=with_lse)
    kv_pos = (page_pos[:, :, None] + torch.arange(
        page, dtype=torch.int32, device=q.device)[None, None]
              ).reshape(B, npg * page)
    kv_valid = kv_pos < lengths[:, None]
    if window is not None:
        kv_valid &= kv_pos >= (lengths[:, None] - window)
    res = attention_ref(q[:, None], k, v, q_pos=(lengths - 1)[:, None],
                        kv_pos=kv_pos, causal=False, kv_valid=kv_valid,
                        softmax_scale=softmax_scale, with_lse=with_lse)
    if with_lse:
        out, lse = res
        return out[:, 0], lse[:, :, 0]
    return res[:, 0]


def paged_prefill_attention_ref(
    q: torch.Tensor,                     # (B, Sq, H, D) chunk queries
    k_new: torch.Tensor,                 # (B, Sq, KVH, D) chunk K
    v_new: torch.Tensor,
    q_pos: torch.Tensor,                 # (Sq,) or (B, Sq) int32
    kv_pos_new: torch.Tensor,            # (Sq,) or (B, Sq) int32
    k_pool: torch.Tensor,                # (n_pages, page, KVH, D)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,          # (B, pages_per_seq) int32
    hist_len: torch.Tensor,              # (B,) int32 valid history tokens
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
):
    """CDSP chunk prefill over [history pages ++ own chunk KV].

    History KV sits in the pool in natural token order, so a history key's
    position is its flat table index and it is valid while
    ``index < hist_len``."""
    if block_tables.dim() != 2:
        raise ValueError("the port serves 2-dim (unsharded) block tables")
    B, Sq = q.shape[:2]
    npg = block_tables.shape[1]
    page = k_pool.shape[1]
    S_h = npg * page
    idx = block_tables.long()
    hk = k_pool[idx].reshape(B, S_h, *k_pool.shape[2:])
    hv = v_pool[idx].reshape(B, S_h, *v_pool.shape[2:])
    hist_pos = torch.arange(S_h, dtype=torch.int32, device=q.device)
    k = torch.cat([hk.to(k_new.dtype), k_new], dim=1)
    v = torch.cat([hv.to(v_new.dtype), v_new], dim=1)
    kv_pos = torch.cat([hist_pos[None].expand(B, S_h),
                        _broadcast_pos(kv_pos_new, B)], dim=1)
    kv_valid = torch.cat(
        [hist_pos[None, :] < hist_len[:, None],
         torch.ones((B, Sq), dtype=torch.bool, device=q.device)], dim=1)
    return attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                         window=window, kv_valid=kv_valid,
                         softmax_scale=softmax_scale)
