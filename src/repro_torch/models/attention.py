"""Attention block: projections + RoPE + mode-dispatched attention core.

Single-device branches of the reference (models/attention.py):
  train / prefill — causal attention over the chunk (K3 on the card), or,
      with a paged history, over [history pages ++ own chunk] (K2 + K3 +
      LSE merge on the card);
  decode — one token per row: the fused paged append+attend tick (K1 on
      the card) over {"k","v","block_table"} pools, or the plain dense
      decode over {"k","v"} buffers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.sharding import ExecContext


def qkv_proj(x: torch.Tensor, p: dict, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    dh = cfg.head_dim_
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.padded_heads, dh),
            k.reshape(B, S, cfg.n_kv_heads, dh),
            v.reshape(B, S, cfg.n_kv_heads, dh))


def out_proj(o: torch.Tensor, p: dict) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"]


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
    {"k","v"} (B, S_max, KVH, D).  history (CDSP chunked prefill): paged
    {"k_pool","v_pool","block_table","len"}, or dense {"k","v","pos"}."""
    B, S, _ = x.shape
    q, k, v = qkv_proj(x, p, cfg)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    pos2d = positions[0] if positions.dim() == 3 else positions

    if mode == "decode" and cache is not None and "block_table" in cache:
        assert cache_len is not None
        bt = cache["block_table"]
        if bt.dim() != 2:
            raise NotImplementedError("sharded paged pools need a mesh; "
                                      "the port runs on one device")
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
        rows = torch.arange(B, device=x.device)
        k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
        k_cache[rows, cache_len.long()] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, cache_len.long()] = v[:, 0].to(v_cache.dtype)
        o = ops.decode_attention(q[:, 0], k_cache, v_cache, cache_len + 1,
                                 window=window, impl=ctx.impl)
        return out_proj(o[:, None], p), {"k": k_cache, "v": v_cache}

    if mode not in ("train", "prefill"):
        raise NotImplementedError(f"attention mode {mode!r}")
    k_self, v_self = k, v
    new_cache = {"k": k_self, "v": v_self} if mode == "prefill" else None
    if history is not None and "block_table" in history:
        if history["block_table"].dim() != 2:
            raise NotImplementedError("sharded paged pools need a mesh; "
                                      "the port runs on one device")
        o = ops.paged_prefill_attention(
            q, k, v, pos2d, pos2d, history["k_pool"], history["v_pool"],
            history["block_table"], history["len"], causal=causal,
            window=window, impl=ctx.impl)
        return out_proj(o, p), new_cache
    kv_pos = pos2d
    if history is not None:
        k = torch.cat([history["k"].to(k.dtype), k], dim=1)
        v = torch.cat([history["v"].to(v.dtype), v], dim=1)
        hpos = history["pos"]
        if hpos.dim() == 1:
            hpos = hpos[None].expand(B, hpos.shape[0])
        kv_pos = torch.cat([hpos, pos2d], dim=1)
    o = ops.attention(q, k, v, pos2d, kv_pos, causal=causal, window=window,
                      impl=ctx.impl)
    return out_proj(o, p), new_cache
