"""Decoder stack over the block pattern.

The layer stack is ``n_blocks`` repetitions of ``cfg.pattern``; parameters
for each pattern position are stacked along a leading n_blocks axis.  The
reference scans the stack with ``lax.scan``; here a Python loop slices the
stacked parameters, caches and histories per block.  Caches keep the
reference's tree: pattern position -> {"self": {...}} with leaves stacked
over n_blocks; a paged pool leaf is (n_blocks, n_pages, page, KVH, D) and
its per-block slice is a view, so the fused decode tick writes the live
pool in place.  A sharded pool leaf is a list of per-shard pools (one per
mesh position; a head-sharded shard a list of its head slices), sliced
shard by shard.

Modes: "train" (logits for every position; under ``ctx.remat`` each block
runs under ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
of its scan body, so its activations are recomputed in the backward), "prefill" (logits at the last
position + the chunk's caches), "decode" (one token + updated caches).
Attention and Mamba-2 mixers with dense or MoE FFNs are ported (the MoE
layers' load-balance losses are summed over the stack, as the reference's
scan carry does).  An encoder-decoder (Whisper) runs its encoder stack over
``encoder_frames`` (the stubbed frontend's (B, S_x, d_model) embeddings,
plus learned positions, non-causal, "encode" mode) in train and prefill;
each decoder layer's cross-attention sub-block reads K/V of the encoder's
output, which prefill hands on as the layer's ``"cross"`` cache and decode
reads back unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (attention_block, cross_attention,
                                          kv_proj)
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (embed, learned_pos, mlp, rms_norm,
                                       unembed)
from repro_torch.models.moe import moe_layer
from repro_torch.models.sharding import ExecContext
from repro_torch.models.ssm import mamba_block


# the encoder's layers (reference transformer.py:178)
_ENCODER_PATTERN = (LayerSpec(mixer="attn", ffn="dense"),)


def _layer(x, spec: LayerSpec, p: dict, cfg: ModelConfig, ctx: ExecContext,
           positions, mode: str, cache: Optional[dict], cache_len,
           causal: bool, history: Optional[dict] = None, encoder_out=None):
    """One pre-norm layer.  Returns (x, new_cache, aux): aux is the MoE
    layer's load-balance loss, None for a layer without one."""
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
    if spec.cross_attn:
        # reference transformer.py:64-78: decode reads the cached cross KV;
        # prefill and train take it from the encoder's output (and prefill
        # hands it on)
        h = rms_norm(x, p["normx"], cfg.norm_eps)
        if mode == "decode":
            xc = cache["cross"]
        else:
            kx, vx = kv_proj(encoder_out, p, cfg, prefix="x_")
            xc = {"k": kx, "v": vx}
        x = x + cross_attention(h, p, cfg, ctx, positions,
                                "cross_decode" if mode == "decode"
                                else "cross", xc)
        if mode in ("prefill", "decode"):
            new_cache["cross"] = xc
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
    if isinstance(tree, list):          # a sharded pool: slice each shard
        return [_slice(t, b) for t in tree]
    return tree[b]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _n_stacked(tree: dict) -> int:
    """The leading (n_blocks) extent of a stacked parameter tree."""
    leaf = next(iter(tree.values()))
    return _n_stacked(leaf) if isinstance(leaf, dict) else leaf.shape[0]


def _stack_forward(x, blocks_p, cfg: ModelConfig, ctx: ExecContext,
                   positions, mode: str, caches, cache_len, causal: bool,
                   history=None, encoder_out=None, pattern=None):
    """The stack of ``pattern`` blocks (default ``cfg.pattern``), as many
    as ``blocks_p`` stacks (the encoder's differ from the decoder's)."""
    pattern = cfg.pattern if pattern is None else pattern

    def block(x, aux_tot, bp, bc, bh):
        new = {}
        for i, spec in enumerate(pattern):
            key = str(i)
            x, new[key], aux = _layer(
                x, spec, bp[key], cfg, ctx, positions, mode,
                None if bc is None else bc.get(key), cache_len, causal,
                history=None if bh is None else bh.get(key),
                encoder_out=encoder_out)
            if aux is not None:
                aux_tot = aux_tot + aux
        return x, aux_tot, new

    remat = ctx.remat and mode == "train"
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    per_block = []
    for b in range(_n_stacked(blocks_p)):
        args = (x, aux_tot, _slice(blocks_p, b), _slice(caches, b),
                _slice(history, b))
        x, aux_tot, new = (checkpoint(block, *args, use_reentrant=False)
                           if remat else block(*args))
        per_block.append(new)
    return x, aux_tot, _restack(per_block, caches, mode)


def _restack(per_block: list, caches, mode: str):
    """Stack per-block caches back over n_blocks.  A paged decode pool, a
    dense decode cache in sequence shards, or a Mamba-2 decode state with
    a ``"next"`` buffer is already the caller's stacked tensor (each block
    wrote its slice in place), and decode reads the cross KV without
    changing it, so all are handed back as they are rather than copied."""
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
            elif src is not None and isinstance(src.get("k"), list):
                # a dense cache in sequence shards: written in place
                ent[part] = {"k": src["k"], "v": src["v"]}
            elif src is not None and part == "cross":
                ent[part] = src
            elif src is not None and "next" in src:
                # a decode state written in place into the caller's spare
                # buffer (models/ssm.py)
                ent[part] = src["next"]
            else:
                ent[part] = _stack([blk[key][part] for blk in per_block])
        out[key] = ent
    return out


def forward(params: dict, cfg: ModelConfig, ctx: ExecContext,
            tokens: torch.Tensor, positions: torch.Tensor, mode: str,
            caches: Optional[dict] = None,
            cache_len: Optional[torch.Tensor] = None,
            history: Optional[dict] = None,
            encoder_frames: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Run the model: tokens (B, S) int, positions (B, S) int32.  Returns
    (logits, aux_loss (the MoE layers' summed load-balance loss; 0 without
    MoE layers), caches).  An encoder-decoder needs ``encoder_frames``
    (B, S_x, d_model) in train and prefill; decode reads the cross KV from
    ``caches``."""
    dtype = getattr(torch, cfg.dtype)
    x = embed(tokens, params["embed"], dtype)
    if cfg.pos_embedding == "learned":
        x = x + learned_pos(positions, params["pos_emb"], dtype)
    encoder_out = None
    if cfg.encoder_decoder and mode != "decode":
        if encoder_frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                             f"encoder_frames in {mode}")
        e = encoder_frames.to(dtype)
        e_pos = torch.arange(e.shape[1], dtype=torch.int32,
                             device=e.device)[None].expand(e.shape[0], -1)
        e = e + learned_pos(e_pos, params["encoder"]["pos_emb"], dtype)
        e, _, _ = _stack_forward(
            e, params["encoder"]["blocks"], cfg, ctx, e_pos,
            "train" if mode == "train" else "encode", None, None,
            causal=False, pattern=_ENCODER_PATTERN)
        encoder_out = rms_norm(e, params["encoder"]["final_norm"],
                               cfg.norm_eps)
    x, aux, new_caches = _stack_forward(x, params["blocks"], cfg, ctx,
                                        positions, mode, caches, cache_len,
                                        causal=True, history=history,
                                        encoder_out=encoder_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        pos2d = positions[0] if positions.dim() == 3 else positions
        last = torch.argmax(pos2d, dim=1)
        x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed(x, table)
    return logits, aux, new_caches
