"""Chunkwise Dynamic Sequence Parallelism — prefill execution (Sec. 4.1).

``chunked_prefill`` runs a request's prompt chunk by chunk: chunk *i*
attends to the KV of chunks < i (cross-chunk causal masking is automatic
via position arrays) plus its own causal self-attention, SSD state and
conv windows are handed from chunk to chunk, and it equals monolithic
prefill (tests/test_torch_cdsp.py).

The serving engine keeps a chunk's history in *paged* pools
(``prefill_chunk_paged``): the chunk reads earlier chunks' KV straight out
of the pages through ``pages_history_view`` and the engine scatters the
chunk's own KV into pages afterwards.  The dense ``prefill_chunk`` /
``_append_history`` path stays as the library oracle.

An encoder-decoder (Whisper) prefills its decoder prompt as one chunk
with the encoder frames (reference cdsp.py:225-231); each layer's cross KV
rides in the history as ``"cross"`` and on into the decode caches.

On a mesh (``ctx.sp_axis``) a chunk runs ring attention over its SP
positions.  Under the serving engine the prefill pool stripes over the
same axis and each shard's history pages rotate through the ring
(``pages_history_view`` builds the per-shard tables).  The dense
``prefill_chunk`` path keeps its history whole on position 0's device;
the ring splits it evenly over the chunk's positions at every layer,
which is the reference's "cache balancing" reshard when the next chunk
runs on a larger group.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ExecContext
from repro_torch.models.transformer import forward
from repro_torch.serving.cache_manager import shard_block_table


def _append_history(cfg: ModelConfig, history: Optional[dict],
                    new_caches: dict, positions: torch.Tensor) -> dict:
    """Fold a chunk's produced caches into the running dense history:
    attention KV is concatenated, SSD state and conv window replaced, the
    cross KV carried."""
    pos2d = positions[0] if positions.dim() == 3 else positions
    out = {}
    for i, spec in enumerate(cfg.pattern):
        key = str(i)
        nc = new_caches[key]["self"]
        if spec.mixer != "attn":
            ent = nc
        else:
            prev = (None if history is None
                    else history.get(key, {}).get("self"))
            nb, B_, L = nc["k"].shape[:3]
            pos_b = pos2d[None].expand(nb, B_, L)
            if prev is None:
                ent = {"k": nc["k"], "v": nc["v"], "pos": pos_b}
            else:
                ent = {"k": torch.cat([prev["k"], nc["k"]], dim=2),
                       "v": torch.cat([prev["v"], nc["v"]], dim=2),
                       "pos": torch.cat([prev["pos"], pos_b], dim=2)}
        out[key] = {"self": ent}
        if "cross" in new_caches[key]:
            out[key]["cross"] = new_caches[key]["cross"]
    return out


def prefill_chunk(params: dict, cfg: ModelConfig, ctx: ExecContext,
                  tokens: torch.Tensor, positions: torch.Tensor,
                  history: Optional[dict] = None,
                  encoder_frames: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, dict]:
    """Run ONE CDSP chunk against the running dense history.  Returns
    (next-token logits (B, 1, V), updated history)."""
    logits, _, new_caches = forward(params, cfg, ctx, tokens, positions,
                                    "prefill", history=history,
                                    encoder_frames=encoder_frames)
    return logits, _append_history(cfg, history, new_caches, positions)


def aux_history_from_caches(cfg: ModelConfig, prev_aux: Optional[dict],
                            new_caches: dict) -> Optional[dict]:
    """Fold one chunk's non-attention state into the running aux history.

    Attention KV lives in pages; only O(1)-in-sequence state rides here:
    a Mamba layer's SSD state and conv window, replaced by each chunk's,
    and an encoder-decoder's cross KV, computed once and carried.  A
    decoder with attention layers only has none, and gets None, as in the
    reference."""
    out: dict = {}
    for i, spec in enumerate(cfg.pattern):
        key = str(i)
        ent = {}
        if spec.mixer != "attn":
            nc = new_caches[key].get("self")
            if nc is not None:
                ent["self"] = nc
        if "cross" in new_caches[key]:
            ent["cross"] = new_caches[key]["cross"]
        elif prev_aux is not None and "cross" in prev_aux.get(key, {}):
            ent["cross"] = prev_aux[key]["cross"]
        if ent:
            out[key] = ent
    return out or None


def pages_history_view(cfg: ModelConfig, pools: dict, block_table,
                       hist_len, aux_history: Optional[dict] = None,
                       active_shards: Optional[int] = None,
                       ) -> Optional[dict]:
    """A ``forward(history=...)`` tree whose attention entries read the
    cross-chunk KV straight out of PagedKVCache pools.

    ``pools`` maps pattern position -> {"k","v"} tensors (nb, n_pages,
    page, KVH, D); ``block_table`` lists the request's physical pages
    covering its first ``hist_len`` tokens in natural order.  Leaves carry
    the leading n_blocks axis; the per-block slice is the paged history
    {"k_pool","v_pool","block_table","len"} the attention block consumes.

    A sequence-parallel sharded pool (PagedKVCache with ``kv_shards > 1``,
    leaves that are lists of per-shard (nb, blocks_per_shard + 1, page,
    KVH, D) tensors) gets the per-shard local tables (nb, n_shards, B,
    npg_local) that the ring-paged prefill consumes
    (core/ring_attention.ring_paged_prefill), built from the global
    striped ids on position 0's device.  ``active_shards`` narrows the
    stripe after an elastic restripe: the tables keep one row per
    physical shard, column j of row s meaning logical page ``j *
    active_shards + s``, and rows past the live stripe are all-scratch."""
    out: dict = {}
    nb = cfg.n_blocks
    bt_b = ln_b = None
    for i, spec in enumerate(cfg.pattern):
        key = str(i)
        ent: dict = {}
        if spec.mixer == "attn":
            p = pools[key]
            if bt_b is None:
                bt = np.asarray(block_table, np.int32)
                if bt.ndim == 1:
                    bt = bt[None]                          # (B=1, npg)
                B_ = bt.shape[0]
                if isinstance(p["k"], list):               # striped pool
                    n_sh, bps = len(p["k"]), p["k"][0].shape[1] - 1
                    act = min(active_shards or n_sh, n_sh)
                    bt = shard_block_table(bt, act, bps, n_slots=n_sh)
                    dev = p["k"][0].device
                else:
                    dev = p["k"].device
                bt = torch.as_tensor(bt, device=dev)
                ln = torch.as_tensor(hist_len, dtype=torch.int32,
                                     device=dev).reshape(-1).expand(B_)
                bt_b = bt[None].expand((nb,) + tuple(bt.shape))
                ln_b = ln[None].expand(nb, B_)
            ent["self"] = {"k_pool": p["k"], "v_pool": p["v"],
                           "block_table": bt_b, "len": ln_b}
        elif aux_history is not None and "self" in aux_history.get(key, {}):
            ent["self"] = aux_history[key]["self"]
        if aux_history is not None and "cross" in aux_history.get(key, {}):
            ent["cross"] = aux_history[key]["cross"]
        if ent:
            out[key] = ent
    return out or None


def prefill_chunk_paged(params: dict, cfg: ModelConfig, ctx: ExecContext,
                        tokens: torch.Tensor, positions: torch.Tensor,
                        pools: dict, block_table, hist_len: int,
                        aux_history: Optional[dict] = None,
                        encoder_frames: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, dict, Optional[dict]]:
    """Run ONE CDSP chunk whose cross-chunk history lives in KV pages.
    Returns (next-token logits (B, 1, V), the chunk's new caches —
    attention entries hold only THIS chunk's KV — and the aux history)."""
    history = None
    if hist_len > 0 or aux_history is not None:
        history = pages_history_view(cfg, pools, block_table, hist_len,
                                     aux_history,
                                     active_shards=ctx.active_pool_shards)
    logits, _, new_caches = forward(params, cfg, ctx, tokens, positions,
                                    "prefill", history=history,
                                    encoder_frames=encoder_frames)
    return logits, new_caches, aux_history_from_caches(cfg, aux_history,
                                                       new_caches)


def chunked_prefill(params: dict, cfg: ModelConfig, ctx: ExecContext,
                    tokens: torch.Tensor, positions: torch.Tensor,
                    chunk_lens: List[int],
                    encoder_frames: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, dict]:
    """Run CDSP prefill over ``chunk_lens`` (sum == S).  Returns
    (next-token logits (B, 1, V), dense history with the full per-layer KV
    in chunk-concatenation storage order).  ``encoder_frames`` go to the
    first chunk; an encoder-decoder's decoder prompt is one chunk."""
    S = tokens.shape[-1]
    assert sum(chunk_lens) == S, (chunk_lens, S)
    if cfg.encoder_decoder and len(chunk_lens) != 1:
        raise ValueError(f"{cfg.name}: an encoder-decoder's decoder prompt "
                         f"prefills as one chunk, got {chunk_lens}")
    history: Optional[dict] = None
    logits = None
    off = 0
    for n, L in enumerate(chunk_lens):
        logits, history = prefill_chunk(
            params, cfg, ctx, tokens[:, off:off + L],
            positions[..., off:off + L], history,
            encoder_frames=encoder_frames if n == 0 else None)
        off += L
    return logits, history


def history_to_decode_caches(cfg: ModelConfig, history: dict,
                             max_seq: int) -> Tuple[dict, torch.Tensor]:
    """Dense history -> dense decode caches in natural order, padded to
    ``max_seq`` (the prefill->decode KV hand-off of the dense oracle).
    SSM layers hand their state over as it is, and so does the cross KV;
    a model with no attention layer gets ``cache_len`` 0, as in the
    reference."""
    caches = {}
    cache_len = None
    for i, spec in enumerate(cfg.pattern):
        ent = history[str(i)]["self"]
        if "cross" in history[str(i)]:
            caches[str(i)] = {"cross": history[str(i)]["cross"]}
        if spec.mixer != "attn":
            caches.setdefault(str(i), {})["self"] = ent
            continue
        k, v, pos = ent["k"], ent["v"], ent["pos"][0]      # pos: (B, C)
        order = torch.argsort(pos, dim=1)                  # (B, C)
        idx = order[None, :, :, None, None].expand_as(k)
        k = torch.gather(k, 2, idx)
        v = torch.gather(v, 2, idx)
        C = k.shape[2]
        pad = max_seq - C
        if pad > 0:
            z = torch.zeros(k.shape[:2] + (pad,) + k.shape[3:],
                            dtype=k.dtype, device=k.device)
            k, v = torch.cat([k, z], dim=2), torch.cat([v, z], dim=2)
        caches.setdefault(str(i), {})["self"] = {"k": k, "v": v}
        cache_len = torch.full((k.shape[1],), C, dtype=torch.int32,
                               device=k.device)
    if cache_len is None:                                  # pure SSM
        ssm = history["0"]["self"]["ssm"]
        cache_len = torch.zeros((ssm.shape[1],), dtype=torch.int32,
                                device=ssm.device)
    return caches, cache_len
