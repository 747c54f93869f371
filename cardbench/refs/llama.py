"""Plain reference of a Llama-architecture decoder: RMSNorm, rotary
embeddings (GPT-NeoX halves), grouped-query causal attention, SwiGLU,
untied or tied unembedding (Touvron et al., arXiv:2302.13971; Yi,
arXiv:2403.04652).

It reads the weight tree the benchmark generated, in the layout of
``cardbench/families/llama.py`` ({"embed", "final_norm", ["unembed"],
"blocks": {"0": {name: (layers, ...)}}}, matrices applied as x @ w), and
computes in float32 with TF32 off, one layer at a time over every
sequence, attention one block of queries at a time, so that it fits
beside nothing else on the card.  It imports nothing of the program.

``mode="fp8"`` is the control: every linear layer's weights (per output
column) and inputs (per token) rounded to float8 e4m3 before the
product, the rest as in float32.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from quant import linear, set_exact_matmul


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, D) at positions 0..S-1; angles in float64."""
    S, _, D = x.shape
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None]
    sin = torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, q_block: int) -> torch.Tensor:
    """Causal GQA attention. q (S, H, D), k/v (S, KVH, D) -> (S, H * D)."""
    S, H, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    qg = q.reshape(S, KVH, G, D).permute(1, 2, 0, 3)        # (KVH, G, S, D)
    kt = k.permute(1, 2, 0)                                  # (KVH, D, S)
    vt = v.permute(1, 0, 2)                                  # (KVH, S, D)
    out = torch.empty((KVH, G, S, D), dtype=q.dtype, device=q.device)
    scale = D ** -0.5
    for a in range(0, S, q_block):
        b = min(S, a + q_block)
        s = torch.matmul(qg[:, :, a:b], kt[:, None, :, :b]) * scale
        qi = torch.arange(a, b, device=q.device)[:, None]
        ki = torch.arange(b, device=q.device)[None]
        s.masked_fill_(ki > qi, float("-inf"))
        out[:, :, a:b] = torch.matmul(torch.softmax(s, dim=-1),
                                      vt[:, None, :b])
        del s
    return out.permute(2, 0, 1, 3).reshape(S, H * D)


def _layer(h, p, c, mode, q_block):
    eps = float(c["rms_norm_eps"])
    H, KVH = c["num_attention_heads"], c["num_key_value_heads"]
    D = c.get("head_dim") or c["hidden_size"] // H
    S = h.shape[0]
    x = _rms(h, p["norm1"], eps)
    q = _rope(linear(x, p["wq"], mode).reshape(S, H, D), c["rope_theta"])
    k = _rope(linear(x, p["wk"], mode).reshape(S, KVH, D), c["rope_theta"])
    v = linear(x, p["wv"], mode).reshape(S, KVH, D)
    h = h + linear(_attention(q, k, v, q_block), p["wo"], mode)
    x = _rms(h, p["norm2"], eps)
    f = p["ffn"]
    return h + linear(F.silu(linear(x, f["wg"], mode)) * linear(x, f["wi"],
                                                               mode),
                      f["wo"], mode)


def _layer_weights(blk: dict, i: int) -> dict:
    return {k: (_layer_weights(v, i) if isinstance(v, dict)
                else v[i].float()) for k, v in blk.items()}


@torch.no_grad()
def logits(weights: dict, c: dict, seqs: Sequence, reads: Sequence,
           mode: str = "fp32", q_block: int = 1024) -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (positions 0..len-1), the
    float32 logits (over the vocabulary) at the positions ``reads[i]``."""
    set_exact_matmul()
    emb = weights["embed"]
    dev = emb.device
    hs = [emb[torch.as_tensor(s, device=dev).long()].float() for s in seqs]
    blk = weights["blocks"]["0"]
    for i in range(c["num_hidden_layers"]):
        p = _layer_weights(blk, i)
        hs = [_layer(h, p, c, mode, q_block) for h in hs]
        del p
    table = weights.get("unembed", emb)
    V = c["vocab_size"]
    out = []
    for h, r in zip(hs, reads):
        x = _rms(h[torch.as_tensor(r, device=dev).long()],
                 weights["final_norm"].float(), float(c["rms_norm_eps"]))
        out.append(linear(x, table[:V].float().t(), mode))
    return out
