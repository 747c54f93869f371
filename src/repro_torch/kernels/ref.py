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

from repro_torch.launch.mesh import head_stripes

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


def attention_ref_blocked(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                          window: Optional[int] = None, kv_valid=None,
                          softmax_scale: Optional[float] = None,
                          with_lse: bool = False, block_q: int = 256):
    """``attention_ref`` one block of ``block_q`` queries at a time
    (reference ``ref.py:86``): the same numbers, row for row, with the
    live logits bounded to one (block_q x Sk) tile a KV head group.  It
    is the plain path wherever the (Sq x Sk) scores would not fit (a
    32k-token prefill's would take 32 x 32768^2 x 4 B).  The reference
    pads the last block with dead queries for ``lax.map``; here the last
    block is just shorter, so no work is spent on padding."""
    B, Sq = q.shape[:2]
    q_pos = _broadcast_pos(q_pos, B)
    outs, lses = [], []
    for s in range(0, Sq, block_q):
        e = min(s + block_q, Sq)
        o, lse = attention_ref(q[:, s:e], k, v, q_pos[:, s:e], kv_pos,
                               causal=causal, window=window,
                               kv_valid=kv_valid,
                               softmax_scale=softmax_scale, with_lse=True)
        outs.append(o)
        lses.append(lse)
    out = torch.cat(outs, dim=1)
    return (out, torch.cat(lses, dim=2)) if with_lse else out


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


def sharded_pool_view(pool, tables: torch.Tensor) -> torch.Tensor:
    """Dense logical-order view of a *sequence-parallel sharded* paged
    pool (serving/cache_manager.PagedKVCache with ``kv_shards > 1``).

    pool: the per-shard pools, a sequence of (blocks_per_shard + 1, page,
    KVH, D) tensors on their positions' devices (or one stacked
    (n_shards, ...) tensor; a head-sharded pool's shard is a list of its
    head slices, read side by side); tables: (n_shards, B, npg_local)
    local page ids, where row s column j holds the sequence's logical
    page ``j * n_shards + s`` (striped layout).  Returns (B, npg_local *
    n_shards * page, KVH, D) on the tables' device, with tokens at their
    logical flat positions — scratch-padded table entries land at
    positions at/past the valid length, so the usual ``idx < length``
    masking covers them."""
    n, B, npg = tables.shape

    def view(stripe):
        g = torch.stack([stripe[s][tables[s].to(stripe[s].device).long()]
                         .to(tables.device) for s in range(n)],
                        dim=2)                      # (B, npg, n, page, ...)
        return g.reshape(B, npg * n * g.shape[3], *g.shape[4:])
    views = [view(st) for st in head_stripes(pool)]
    return views[0] if len(views) == 1 else torch.cat(views, dim=-2)


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
    (default: flat table order); length and window masks follow it.

    Also accepts the sequence-parallel sharded layout (3-dim tables
    (n_shards, B, npg_local) over per-shard pools): the striped pages are
    gathered back into logical order first (``sharded_pool_view``)."""
    if block_tables.dim() == 3:
        if page_pos is not None:
            raise ValueError("page_pos applies to shard-local tables")
        return decode_attention_ref(
            q, sharded_pool_view(k_pool, block_tables),
            sharded_pool_view(v_pool, block_tables), lengths,
            window=window, softmax_scale=softmax_scale, with_lse=with_lse)
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
    ``index < hist_len``.  A sharded pool (3-dim tables) is read through
    its logical-order view (``sharded_pool_view``)."""
    B, Sq = q.shape[:2]
    if block_tables.dim() == 3:
        hk = sharded_pool_view(k_pool, block_tables)
        hv = sharded_pool_view(v_pool, block_tables)
        S_h = hk.shape[1]
    else:
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


# ------------------------------------------------------------------ mamba-2
def _rep_heads(m: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    return torch.repeat_interleave(m.float(), rep, dim=dim)


def ssd_ref(x: torch.Tensor,              # (B, S, H, P) per-head inputs
            dt: torch.Tensor,             # (B, S, H) softplus'd step sizes
            A: torch.Tensor,              # (H,) negative decay rates
            Bm: torch.Tensor,             # (B, S, G, N) input matrices
            Cm: torch.Tensor,             # (B, S, G, N) output matrices
            *, h0: Optional[torch.Tensor] = None,   # (B, H, P, N)
            return_state: bool = False):
    """Sequential SSD (state-space duality) recurrence — the oracle.

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T ;  y_t = C_t h_t^T.
    Grouped B/C: head h uses group h // (H // G)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf, dtf = x.float(), dt.float()
    Bf, Cf = _rep_heads(Bm, rep, 2), _rep_heads(Cm, rep, 2)
    decay = torch.exp(dtf * A.float()[None, None, :])          # (B, S, H)
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = (h * decay[:, t, :, None, None]
             + (dtf[:, t, :, None] * xf[:, t])[..., None]
             * Bf[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, h) if return_state else y


def ssd_chunked_ref(x, dt, A, Bm, Cm, *, chunk: int = 64, h0=None,
                    return_state: bool = False,
                    dtype: torch.dtype = torch.float32):
    """Chunked SSD (quadratic within a chunk, recurrent across chunks) —
    matches ``ssd_ref``; the algorithm of the CUDA kernel K5.

    Written as explicit steps with the heads split as (G, H/G) so that B
    and C are never repeated per head and no (B, nc, L, L, H, P) tensor is
    formed: the largest intermediates are the per-head decay matrix and
    scores, (B, nc, G, H/G, L, L).  Computes in ``dtype``; y comes back in
    x's dtype, the state in ``dtype``."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    assert S % chunk == 0, (S, chunk)
    nc, L = S // chunk, chunk
    xf = x.to(dtype).reshape(B_, nc, L, G, R, P)
    dtf = dt.to(dtype).reshape(B_, nc, L, G, R)
    Bf = Bm.to(dtype).reshape(B_, nc, L, G, N)
    Cf = Cm.to(dtype).reshape(B_, nc, L, G, N)

    a = dtf * A.to(dtype).reshape(G, R)                        # <= 0
    a_cum = torch.cumsum(a, dim=2)                             # inclusive
    a_total = a_cum[:, :, -1]                                  # (B,nc,G,R)
    ac = a_cum.permute(0, 1, 3, 4, 2)                          # (B,nc,G,R,L)

    # intra-chunk: y_i += sum_{j<=i} exp(a_cum_i - a_cum_j) dt_j (C_i.B_j) x_j
    # (the upper triangle is selected out before exp: it would overflow)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    seg = ac[..., :, None] - ac[..., None, :]                  # (..,L,L)
    decay = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                        0.0)
    scores = torch.einsum("bclgn,bcmgn->bcglm", Cf, Bf)        # C B^T
    w_in = scores[:, :, :, None] * decay \
        * dtf.permute(0, 1, 3, 4, 2)[..., None, :]             # (..,L,L)
    y = torch.einsum("bcgrlm,bcmgrp->bclgrp", w_in, xf)
    del seg, decay, w_in

    # chunk states: sum_j exp(a_total - a_cum_j) dt_j x_j B_j^T
    w = torch.exp(a_total[:, :, None] - a_cum) * dtf           # (B,nc,L,G,R)
    states = torch.einsum("bclgrp,bclgn->bcgrpn", xf * w[..., None], Bf)

    # inter-chunk recurrence over the chunk states
    h = (torch.zeros((B_, G, R, P, N), dtype=dtype, device=x.device)
         if h0 is None else h0.to(dtype).reshape(B_, G, R, P, N))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                       # state BEFORE c
        h = h * torch.exp(a_total[:, c])[..., None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # (B,nc,G,R,P,N)

    # inter-chunk output: y_i += exp(a_cum_i) C_i h_prev^T
    y = y + torch.einsum("bclgn,bcgrpn->bclgrp", Cf, h_prev) \
        * torch.exp(a_cum)[..., None]
    y = y.reshape(B_, S, H, P).to(x.dtype)
    h = h.reshape(B_, H, P, N)
    return (y, h) if return_state else y


def ssd_decode_ref(x, dt, A, Bm, Cm, h, out=None):
    """One-token SSD state update.  x (B, H, P), dt (B, H), Bm/Cm
    (B, G, N), h (B, H, P, N) -> (y (B, H, P), h_new fp32); with ``out``
    (B, H, P, N) fp32 the new state is written there and returned."""
    rep = x.shape[1] // Bm.shape[1]
    Bf, Cf = _rep_heads(Bm, rep, 1), _rep_heads(Cm, rep, 1)
    dtf = dt.float()
    decay = torch.exp(dtf * A.float()[None, :])                # (B, H)
    h_new = torch.mul(h.float(), decay[:, :, None, None], out=out)
    h_new += (dtf[:, :, None] * x.float())[..., None] * Bf[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Cf, h_new).to(x.dtype)
    return y, h_new
