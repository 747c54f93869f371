"""Basic transformer layers: RMS norm, rotary embeddings, MLP, embeddings
(token and learned positional).

Plain functions on tensors; parameters are the dict tree of ``params.py``,
stored in ``cfg.dtype``.  Computation dtype follows the input.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def rope_freqs(head_dim_rot: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies for the rotary embedding (half-dim), fp32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim_rot, 2,
                                         dtype=torch.float32, device=device)
                            / head_dim_rot))


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    # GPT-NeoX half split: first half / second half
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mrope_sections(rot: int, sections) -> torch.Tensor:
    """Which of M-RoPE's three position rows (temporal, height, width)
    drives each of the ``rot / 2`` frequencies: ``sections`` (given for
    head_dim 128) scaled to ``rot / 2`` as the reference and HF qwen2-vl
    do, each frequency in the section its index falls in.  (rot/2,) int."""
    secs = torch.tensor(sections, dtype=torch.float64)
    bounds = torch.cumsum((secs * ((rot // 2) / secs.sum())).to(torch.int32),
                          0)
    idx = torch.arange(rot // 2)
    return (idx[None] >= bounds[:, None]).sum(0).clamp(0, 2)


@functools.lru_cache(maxsize=None)
def _mrope_one_hot(rot: int, sections: tuple, device: torch.device
                   ) -> torch.Tensor:
    """(rot/2, 3) fp32 one-hot of ``mrope_sections`` on ``device``, made
    once: a copy from host memory inside a captured decode tick would
    read host memory that is gone when the graph replays."""
    return torch.nn.functional.one_hot(
        mrope_sections(rot, sections), 3).to(torch.float32).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32, or (3, B, S) for M-RoPE.
    Standard, partial (the first ``partial_rotary_factor`` of head_dim)
    and M-RoPE (qwen2-vl: three position rows, each driving one section
    of the frequencies); cos/sin are cast to the activation dtype before
    rotating."""
    if cfg.rope_type == "none":
        return x
    if cfg.rope_type not in ("standard", "partial", "mrope"):
        raise NotImplementedError(f"rope_type {cfg.rope_type!r}")
    dh = x.shape[-1]
    rot = int(dh * cfg.partial_rotary_factor) if cfg.rope_type == "partial" \
        else dh
    rot = (rot // 2) * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = rope_freqs(rot, cfg.rope_theta, x.device)
    if cfg.rope_type == "mrope":
        if positions.dim() != 3:
            raise ValueError("mrope needs (3, B, S) positions")
        ang = positions[..., None].float() * inv           # (3, B, S, rot/2)
        one_hot = _mrope_one_hot(rot, tuple(cfg.mrope_sections),
                                 x.device)                  # (rot/2, 3)
        ang = torch.einsum("tbsk,kt->bsk", ang, one_hot)    # (B, S, rot/2)
    else:
        if positions.dim() == 3:
            positions = positions[0]
        ang = positions[..., None].float() * inv               # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    out = _rotate(x_rot, cos, sin)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def mlp(x: torch.Tensor, p: dict, mlp_type: str) -> torch.Tensor:
    """Position-wise FFN; p holds 'wi'/'wo' (+ 'wg' for swiglu)."""
    if mlp_type == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif mlp_type == "relu2":
        h = torch.square(F.relu(x @ p["wi"]))
    elif mlp_type == "gelu":                    # jax.nn.gelu's default
        h = F.gelu(x @ p["wi"], approximate="tanh")
    else:
        raise NotImplementedError(f"mlp_type {mlp_type!r}")
    return h @ p["wo"]


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    return table[tokens.long()].to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return x @ table.t()


def learned_pos(positions: torch.Tensor, table: torch.Tensor,
                dtype) -> torch.Tensor:
    """Learned positional embeddings (Whisper): rows of ``table`` at
    ``positions`` (B, S), or at the first row of (3, B, S) positions,
    clipped to the table as the reference does."""
    if positions.dim() == 3:
        positions = positions[0]
    idx = positions.long().clamp(0, table.shape[0] - 1)
    return table[idx].to(dtype)
