"""Plain reference of a Mamba-2 language model: pre-norm residual blocks
of the SSD mixer (Dao & Gu, arXiv:2405.21060) — input projections to z,
(x, B, C) and dt; a causal depthwise convolution over (x, B, C) and
SiLU; the state-space recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t h_t + D x_t

with dt = softplus(dt_raw + dt_bias) and A = -exp(A_log); the gated
RMSNorm rmsnorm(y * silu(z)); the output projection — then a final
RMSNorm and the tied embedding as the head.

The recurrence is computed in its chunked (state-space dual) form in
float32: quadratic within a chunk of ``chunk_size`` steps, a state
handed from chunk to chunk.  It reads the weight tree of
``cardbench/families/mamba2.py``, one layer at a time over every
sequence, and imports nothing of the program.  ``mode="fp8"`` is the
control: every linear layer in float8 e4m3 (``quant.linear``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from quant import linear, set_exact_matmul


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution: out[t] = b + sum_k w[k] x[t-K+1+k].
    x (S, ch), w (K, ch)."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = b.expand_as(x).clone()
    for k in range(K):
        out += w[k] * xp[k:k + x.shape[0]]
    return out


def ssd(x, dt, A, Bm, Cm, chunk: int, block: int = 16) -> torch.Tensor:
    """y of the recurrence from h_0 = 0. x (S, H, P), dt (S, H), A (H,),
    Bm/Cm (S, G, N); head h reads group h // (H / G).  ``block`` chunks
    at a time, the state carried between blocks."""
    S, H, P = x.shape
    G, N = Bm.shape[1:]
    R = H // G
    pad = -S % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))          # dt = 0: the identity step
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = x.shape[0] // chunk
    L = chunk
    xg = (x * dt[..., None]).reshape(nc, L, G, R, P)
    a = (dt * A).reshape(nc, L, G, R)
    Bc = Bm.reshape(nc, L, G, N)
    Cc = Cm.reshape(nc, L, G, N)
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    h = torch.zeros((G, R, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, nc, block):
        sl = slice(c0, min(nc, c0 + block))
        acum = torch.cumsum(a[sl], dim=1)                     # (b, L, G, R)
        # within each chunk: sum over s <= t of C_t.B_s exp(A_t - A_s) x_s
        seg = acum[:, :, None] - acum[:, None]                # (b, t, s, G, R)
        decay = torch.exp(seg.masked_fill(
            ~causal[None, :, :, None, None], float("-inf")))
        cb = torch.einsum("btgn,bsgn->btsg", Cc[sl], Bc[sl])
        y = torch.einsum("btsg,btsgr,bsgrp->btgrp", cb, decay, xg[sl])
        # each chunk's own contribution to the state at its end
        to_end = torch.exp(acum[:, -1:] - acum)                # (b, L, G, R)
        st = torch.einsum("bsgn,bsgr,bsgrp->bgrpn", Bc[sl], to_end, xg[sl])
        total = torch.exp(acum[:, -1])                         # (b, G, R)
        # the state entering each chunk, chunk by chunk
        h_in = []
        for j in range(st.shape[0]):
            h_in.append(h)
            h = h * total[j][..., None, None] + st[j]
        h_in = torch.stack(h_in)                               # (b,G,R,P,N)
        y = y + torch.einsum("btgn,bgrpn,btgr->btgrp", Cc[sl], h_in,
                             torch.exp(acum))
        ys.append(y)
    return torch.cat(ys).reshape(nc * L, H, P)[:S]


def _layer(h, p, c, mode):
    eps = float(c["norm_epsilon"])
    d = c["d_model"]
    d_in = c["expand"] * d
    P, G, N = c["headdim"], c["ngroups"], c["d_state"]
    H = d_in // P
    S = h.shape[0]
    x = _rms(h, p["norm1"], eps)
    z = linear(x, p["wz"], mode)
    xbc = F.silu(_conv(linear(x, p["wxbc"], mode), p["conv_w"], p["conv_b"]))
    dt = F.softplus(linear(x, p["wdt"], mode) + p["dt_bias"])
    xs = xbc[:, :d_in].reshape(S, H, P)
    Bm = xbc[:, d_in:d_in + G * N].reshape(S, G, N)
    Cm = xbc[:, d_in + G * N:].reshape(S, G, N)
    y = ssd(xs, dt, -torch.exp(p["A_log"]), Bm, Cm, c["chunk_size"])
    y = (y + p["D"][:, None] * xs).reshape(S, d_in)
    y = _rms(y * F.silu(z), p["norm"], eps)
    return h + linear(y, p["wout"], mode)


@torch.no_grad()
def logits(weights: dict, c: dict, seqs: Sequence, reads: Sequence,
           mode: str = "fp32") -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]``, the float32 logits (over the
    vocabulary) at the positions ``reads[i]``."""
    set_exact_matmul()
    emb = weights["embed"]
    dev = emb.device
    hs = [emb[torch.as_tensor(s, device=dev).long()].float() for s in seqs]
    blk = weights["blocks"]["0"]
    for i in range(c["n_layer"]):
        p = {k: v[i].float() for k, v in blk.items()}
        hs = [_layer(h, p, c, mode) for h in hs]
        del p
    table = weights.get("unembed", emb)
    V = c["vocab_size"]
    out = []
    for h, r in zip(hs, reads):
        x = _rms(h[torch.as_tensor(r, device=dev).long()],
                 weights["final_norm"].float(), float(c["norm_epsilon"]))
        out.append(linear(x, table[:V].float().t(), mode))
    return out
