"""Mamba-2 (SSD) mixer block on one device.

Projections -> short causal depthwise conv over (x, B, C) -> SSD scan ->
gated RMSNorm -> output projection (reference models/ssm.py).  Prefill and
train run the chunked scan (K5 on the card); decode keeps a (conv window,
SSD state) cache per layer and steps it in plain PyTorch.  A CDSP chunk
takes the previous chunk's conv window and state as its cache and hands
its own on: that is how an SSM's prefill is split into chunks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compat import causal_depthwise_conv
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.sharding import ExecContext


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x (B, S, ch); w (K, ch); b (ch,); ``init``
    (B, K-1, ch) carried in from the previous chunk (default zeros)."""
    out = causal_depthwise_conv(
        x, w.to(x.dtype), None if init is None else init.to(x.dtype))
    return out + b.to(x.dtype)


def mamba_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                ctx: ExecContext, mode: str, cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B, S, d).  Returns (out, new_cache); the cache is
    {"conv": (B, K-1, conv_ch), "ssm": (B, H, P, N) fp32}."""
    s = cfg.ssm
    B, S, _ = x.shape
    dtype = x.dtype
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    G, N = s.ngroups, s.d_state
    conv_ch = d_in + 2 * G * N

    z = x @ p["wz"]                                             # (B,S,d_in)
    xbc = x @ p["wxbc"]                                         # (B,S,ch)
    dt = F.softplus((x @ p["wdt"]).float() + p["dt_bias"])      # (B,S,H)
    A = -torch.exp(p["A_log"])                                  # (H,)

    if mode == "decode":
        assert cache is not None
        xbc_in = torch.cat([cache["conv"].to(dtype), xbc], dim=1)
        new_conv = xbc_in[:, 1:]
        conv_out = torch.einsum("bkc,kc->bc", xbc_in, p["conv_w"].to(dtype)) \
            + p["conv_b"].to(dtype)
        xbc_c = F.silu(conv_out)[:, None]                       # (B,1,ch)
    else:
        prev = None if cache is None else cache.get("conv")
        xbc_c = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"],
                                    init=prev))
        # next conv window = the last K-1 inputs INCLUDING the carried
        # window (a chunk shorter than K-1 must not truncate it)
        hist = xbc if prev is None else torch.cat([prev.to(dtype), xbc],
                                                  dim=1)
        if hist.shape[1] < s.d_conv - 1:
            hist = torch.cat([hist.new_zeros(
                (B, s.d_conv - 1 - hist.shape[1], conv_ch)), hist], dim=1)
        # a copy, so the cache does not hold the whole chunk's projection
        new_conv = hist[:, -(s.d_conv - 1):].clone()

    xs = xbc_c[..., :d_in].reshape(B, -1, H, s.head_dim)
    Bm = xbc_c[..., d_in:d_in + G * N].reshape(B, -1, G, N)
    Cm = xbc_c[..., d_in + G * N:].reshape(B, -1, G, N)

    if mode == "decode":
        y, h_new = ops.ssd_decode(xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                  cache["ssm"])
        y = y[:, None]                                          # (B,1,H,P)
    else:
        if ctx.sp_axis is not None and ctx.mesh is not None:
            raise NotImplementedError(
                "the sequence-parallel SSD scan over ctx.sp_axis (sp_ssd, "
                "K5 per position) is a later slice of the port")
        h0 = None if cache is None else cache.get("ssm")
        y, h_new = ops.ssd(xs, dt, A, Bm, Cm, h0=h0,
                           chunk=min(s.chunk_size, S), impl=ctx.impl)

    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, -1, d_in).to(dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["wout"]

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"conv": new_conv.to(dtype), "ssm": h_new}
    return out, new_cache
