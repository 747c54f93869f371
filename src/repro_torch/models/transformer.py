"""Decoder stack over the block pattern.

The layer stack is ``n_blocks`` repetitions of ``cfg.pattern``; parameters
for each pattern position are stacked along a leading n_blocks axis.  The
reference scans the stack with ``lax.scan``; here a Python loop slices the
stacked parameters, caches and histories per block.  Caches keep the
reference's tree: pattern position -> {"self": {...}} with leaves stacked
over n_blocks; a paged pool leaf is (n_blocks, n_pages, page, KVH, D) and
its per-block slice is a view, so the fused decode tick writes the live
pool in place.

Modes: "train" (logits for every position), "prefill" (logits at the last
position + the chunk's caches), "decode" (one token + updated caches).
Attention and Mamba-2 mixers with dense or MoE FFNs are ported (the MoE
layers' load-balance losses are summed over the stack, as the reference's
scan carry does); cross attention and encoder stacks raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.attention import attention_block
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import embed, mlp, rms_norm, unembed
from repro_torch.models.moe import moe_layer
from repro_torch.models.sharding import ExecContext
from repro_torch.models.ssm import mamba_block


def _layer(x, spec: LayerSpec, p: dict, cfg: ModelConfig, ctx: ExecContext,
           positions, mode: str, cache: Optional[dict], cache_len,
           causal: bool, history: Optional[dict] = None):
    """One pre-norm layer.  Returns (x, new_cache, aux): aux is the MoE
    layer's load-balance loss, None for a layer without one."""
    if spec.cross_attn:
        raise NotImplementedError(
            f"{cfg.name}: cross attention layers are not ported yet")
    aux = None
    new_cache = {}
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        window = ctx.window if ctx.window is not None else cfg.sliding_window
        o, c = attention_block(
            h, p, cfg, ctx, positions, mode,
            cache=None if cache is None else cache.get("self"),
            cache_len=cache_len, window=window, causal=causal,
            history=None if history is None else history.get("self"))
        if c is not None and mode in ("prefill", "decode"):
            new_cache["self"] = c
    else:
        # a CDSP chunk's SSM history (the previous chunk's conv window and
        # state) is its cache
        hist = None if history is None else history.get("self")
        o, c = mamba_block(h, p, cfg, ctx, mode,
                           cache=(hist if hist is not None else
                                  (None if cache is None
                                   else cache.get("self"))))
        if c is not None:
            new_cache["self"] = c
    x = x + o
    if spec.ffn != "none":
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if spec.ffn == "moe":
            o, aux = moe_layer(h, p["moe"], cfg, ctx)
        else:
            o = mlp(h, p["ffn"], cfg.mlp_type)
        x = x + o
    return x, new_cache, aux


def _slice(tree, b: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _slice(v, b) for k, v in tree.items()}
    return tree[b]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stack_forward(x, blocks_p, cfg: ModelConfig, ctx: ExecContext,
                   positions, mode: str, caches, cache_len, causal: bool,
                   history=None):
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    per_block = []
    for b in range(cfg.n_blocks):
        bp, bc, bh = _slice(blocks_p, b), _slice(caches, b), \
            _slice(history, b)
        new = {}
        for i, spec in enumerate(cfg.pattern):
            key = str(i)
            x, new[key], aux = _layer(
                x, spec, bp[key], cfg, ctx, positions, mode,
                None if bc is None else bc.get(key), cache_len, causal,
                history=None if bh is None else bh.get(key))
            if aux is not None:
                aux_tot = aux_tot + aux
        per_block.append(new)
    return x, aux_tot, _restack(per_block, caches, mode)


def _restack(per_block: list, caches, mode: str):
    """Stack per-block caches back over n_blocks.  A paged decode pool is
    already the caller's stacked tensor (each block wrote its slice in
    place), so it is handed back as is rather than copied."""
    if mode not in ("prefill", "decode"):
        return None
    out = {}
    for key in per_block[0]:
        ent = {}
        for part in per_block[0][key]:
            src = None if caches is None else caches.get(key, {}).get(part)
            if src is not None and "block_table" in src:
                ent[part] = {"k": src["k"], "v": src["v"],
                             "block_table": src["block_table"]}
            else:
                ent[part] = _stack([blk[key][part] for blk in per_block])
        out[key] = ent
    return out


def forward(params: dict, cfg: ModelConfig, ctx: ExecContext,
            tokens: torch.Tensor, positions: torch.Tensor, mode: str,
            caches: Optional[dict] = None,
            cache_len: Optional[torch.Tensor] = None,
            history: Optional[dict] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Run the model: tokens (B, S) int, positions (B, S) int32.  Returns
    (logits, aux_loss (the MoE layers' summed load-balance loss; 0 without
    MoE layers), caches)."""
    if cfg.encoder_decoder:
        raise NotImplementedError("encoder-decoder models are not ported yet")
    dtype = getattr(torch, cfg.dtype)
    x = embed(tokens, params["embed"], dtype)
    x, aux, new_caches = _stack_forward(x, params["blocks"], cfg, ctx,
                                        positions, mode, caches, cache_len,
                                        causal=True, history=history)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        pos2d = positions[0] if positions.dim() == 3 else positions
        last = torch.argmax(pos2d, dim=1)
        x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed(x, table)
    return logits, aux, new_caches
