"""Mixture-of-Experts FFN: capacity-based routing with three execution
strategies.

1. one-hot einsum dispatch (the default) — the dispatch and combine
   products cost O(g·E·C·d);
2. gather/scatter dispatch (``ctx.moe_gather_dispatch``) — the same
   routing with ~zero dispatch FLOPs;
3. expert parallelism (``ctx.moe_ep`` on a mesh, ``_moe_ep``) — the
   experts split over ``ctx.moe_ep_axis()``, position i owning experts
   [i·E/n, (i+1)·E/n); each token position routes its groups and
   dispatches by gather, the slot tensor is regrouped by owner (the
   reference's tiled ``all_to_all``), each owner runs its experts, and
   the outputs are regrouped back and combined.  ``moe_layer`` takes it
   exactly where the reference does (``_ep_applies``).

Tokens are routed in groups of ``GROUP_SIZE`` (the last group padded with
zero rows, which are routed and take capacity like any other).  Tokens
over an expert's per-group capacity are dropped (the residual passes
through).  Shared experts (Qwen2-MoE) run as an always-on dense MLP.  A
Switch-style load-balance auxiliary loss is returned for training.

Every cast point of the reference (models/moe.py) is kept: the router
product in the activation dtype, the softmax and the top-k renormalisation
in fp32, the dispatch one-hot and the combine weights rounded to the
activation dtype before their products.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import at, to
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import mlp
from repro_torch.models.sharding import ExecContext

GROUP_SIZE = 512
# expert-parallel islands run (``_moe_ep``), for the card's smoke run
ep_calls = 0


def _capacity(g: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(math.ceil(g * top_k * cf / n_experts))
    return max(4, ((c + 3) // 4) * 4) if g >= 16 else max(1, c)


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values by lower index first.  ``torch.topk``
    promises no order among equal values, so the top k come from a stable
    descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ----------------------------------------------------------------- routing
def _route(xt: torch.Tensor, router_w: torch.Tensor, m: MoEConfig, E: int,
           C: int) -> dict:
    """xt: (n, g, d) -> routing tensors (all (n, g, k)-shaped or similar)."""
    dtype = xt.dtype
    logits = torch.einsum("ngd,de->nge", xt, router_w.to(dtype))
    gates = torch.softmax(logits.float(), dim=-1)                  # (n,g,E)
    top_gates, top_idx = top_k_stable(gates, m.top_k)              # (n,g,k)
    top_gates = top_gates / torch.clamp(
        top_gates.sum(dim=-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(top_idx, E).to(torch.int32)                 # (n,g,k,E)
    n_g, g = xt.shape[:2]
    flat = onehot.reshape(n_g, g * m.top_k, E)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat      # exclusive
    within = (pos.reshape(n_g, g, m.top_k, E) * onehot).sum(
        dim=-1, dtype=torch.int32)
    keep = within < C
    return dict(gates=gates, top_gates=top_gates, top_idx=top_idx,
                onehot=onehot, within=within, keep=keep)


# ---------------------------------------------------------------- dispatch
def _dispatch_gather(xt: torch.Tensor, r: dict, E: int, C: int):
    """-> (xe: (n, E, C, d), the slot of each (token, choice)).  A dropped
    (token, choice) goes to slot C, one past the end: the reference's
    scatter discards it (``mode="drop"``); here it lands in a spare slot
    that is cut off."""
    n_g, g, _ = xt.shape
    dev = xt.device
    tok = torch.arange(g, device=dev)[None, :, None].expand_as(r["top_idx"])
    n_idx = torch.arange(n_g, device=dev)[:, None, None].expand_as(
        r["top_idx"])
    safe_pos = torch.where(r["keep"], r["within"], C)
    slot_token = torch.zeros((n_g, E, C + 1), dtype=torch.long, device=dev)
    slot_token[n_idx, r["top_idx"], safe_pos] = tok
    slot_valid = torch.zeros((n_g, E, C + 1), dtype=torch.bool, device=dev)
    slot_valid[n_idx, r["top_idx"], safe_pos] = r["keep"]
    slot_token, slot_valid = slot_token[..., :C], slot_valid[..., :C]
    rows = torch.arange(n_g, device=dev)[:, None]
    xe = xt[rows, slot_token.reshape(n_g, E * C)].reshape(n_g, E, C, -1)
    xe = xe * slot_valid[..., None].to(xt.dtype)
    return xe, safe_pos


def _combine_gather(ye: torch.Tensor, r: dict, safe_pos: torch.Tensor,
                    E: int, C: int) -> torch.Tensor:
    n_g, d = ye.shape[0], ye.shape[-1]
    g, k = r["top_idx"].shape[1:]
    ye_flat = ye.reshape(n_g, E * C, d)
    # a dropped choice's slot is past its expert's end: the reference's
    # read clips it into range (``mode="clip"``) and weights it by zero
    slot_of_tok = torch.clamp(r["top_idx"] * C + safe_pos, max=E * C - 1)
    rows = torch.arange(n_g, device=ye.device)[:, None]
    y_k = ye_flat[rows, slot_of_tok.reshape(n_g, g * k)].reshape(
        n_g, g, k, d)
    w_k = (r["top_gates"] * r["keep"]).to(ye.dtype)                # (n,g,k)
    return torch.einsum("ngk,ngkd->ngd", w_k, y_k)


def _dispatch_einsum(xt: torch.Tensor, r: dict, E: int, C: int):
    safe_pos = torch.where(r["keep"], r["within"], C).long()
    pos_oh = F.one_hot(safe_pos, C + 1).float()[..., :C]           # (n,g,k,C)
    disp = torch.einsum("ngke,ngkc->ngec", r["onehot"].float(), pos_oh)
    xe = torch.einsum("ngec,ngd->necd", disp.to(xt.dtype), xt)
    return xe, pos_oh


def _combine_einsum(ye: torch.Tensor, r: dict,
                    pos_oh: torch.Tensor) -> torch.Tensor:
    comb = torch.einsum("ngk,ngke,ngkc->ngec", r["top_gates"].float(),
                        r["onehot"].float(), pos_oh)
    return torch.einsum("ngec,necd->ngd", comb.to(ye.dtype), ye)


# ------------------------------------------------------------- expert FFN
def _expert_ffn(xe: torch.Tensor, p_exp: dict, mlp_type: str
                ) -> torch.Tensor:
    dtype = xe.dtype
    we_i = p_exp["wi"].to(dtype)
    we_o = p_exp["wo"].to(dtype)
    if mlp_type == "swiglu":
        we_g = p_exp["wg"].to(dtype)
        h = F.silu(torch.einsum("necd,edf->necf", xe, we_g)) * \
            torch.einsum("necd,edf->necf", xe, we_i)
    else:
        h = torch.einsum("necd,edf->necf", xe, we_i)
        h = torch.square(F.relu(h)) if mlp_type == "relu2" \
            else F.gelu(h, approximate="tanh")
    return torch.einsum("necf,efd->necd", h, we_o)


def _aux_loss(r: dict, E: int) -> torch.Tensor:
    density = r["onehot"].float().amax(dim=2).mean(dim=1)          # (n,E)
    prob = r["gates"].mean(dim=1)
    return (E * (density * prob).sum(dim=-1).mean()).float()


# ------------------------------------------------------- token grouping io
def _group_tokens(x: torch.Tensor, g: int):
    B, S, d = x.shape
    T = B * S
    pad = (-T) % g
    xt = x.reshape(T, d)
    if pad:
        xt = torch.cat([xt, torch.zeros((pad, d), dtype=x.dtype,
                                        device=x.device)], dim=0)
    return xt.reshape(-1, g, d), T, pad


def _ungroup(y: torch.Tensor, T: int, B: int, S: int, d: int
             ) -> torch.Tensor:
    return y.reshape(-1, d)[:T].reshape(B, S, d)


def _token_axes(ctx: ExecContext, S: int):
    """The axes a layer's token groups are split over (reference
    ``_token_axes``): a one-token tick's are the batch axes, a chunk's
    the pod and SP axes, else the batch axes."""
    if S == 1:
        return ctx.batch_axes
    if ctx.sp_axis is not None:
        return tuple(a for a in (ctx.pod_axis, ctx.sp_axis) if a)
    return ctx.batch_axes


def _ep_applies(ctx: ExecContext, E: int, n_groups: int,
                token_axes) -> bool:
    """The reference's EP condition: ``moe_ep`` on a mesh, the experts
    dividing over the EP axis and the token groups over the token
    axes."""
    ep_ax = ctx.moe_ep_axis()
    tok_div = math.prod(ctx.axis_size(a) for a in token_axes or ())
    return (ep_ax is not None and E % ctx.axis_size(ep_ax) == 0
            and n_groups % max(tok_div, 1) == 0 and ctx.mesh is not None)


# ------------------------------------------------------------- main layer
def moe_layer(x: torch.Tensor, p: dict, cfg: ModelConfig, ctx: ExecContext
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    m = cfg.moe
    B, S, d = x.shape
    E = m.n_experts
    g = min(GROUP_SIZE, B * S)
    C = _capacity(g, m.top_k, E, m.capacity_factor)
    xt, T, _ = _group_tokens(x, g)
    token_axes = _token_axes(ctx, S)
    if _ep_applies(ctx, E, xt.shape[0], token_axes):
        y, aux = _moe_ep(xt, p, cfg, ctx, E, C, token_axes)
    else:
        r = _route(xt, p["router"], m, E, C)
        if ctx.moe_gather_dispatch:
            xe, slots = _dispatch_gather(xt, r, E, C)
            y = _combine_gather(_expert_ffn(xe, p["experts"],
                                            cfg.mlp_type), r, slots, E, C)
        else:
            xe, pos_oh = _dispatch_einsum(xt, r, E, C)
            y = _combine_einsum(_expert_ffn(xe, p["experts"],
                                            cfg.mlp_type), r, pos_oh)
        aux = _aux_loss(r, E)
    y = _ungroup(y, T, B, S, d)
    if m.n_shared:
        y = y + mlp(x, p["shared"], cfg.mlp_type)
    return y, aux


# -------------------------------------------------------- expert parallel
def _moe_ep(xt: torch.Tensor, p: dict, cfg: ModelConfig, ctx: ExecContext,
            E: int, C: int, token_axes):
    """Expert-parallel MoE on the mesh driven by this process (reference
    ``_moe_ep``).

    The token groups ``xt`` (n_g, g, d) split contiguously over the
    token axes' positions (one part, on position 0, when the tokens are
    replicated: the reference then computes the same part on every
    position).  Each part is routed and dispatched by gather into its
    slots (n_l, E, C, d).  The owner of experts [i·E/n, (i+1)·E/n), the
    i-th position of the EP axis, takes those experts' slots of every
    part (the tiled ``all_to_all``), runs its experts on views of the
    stacked weights (never copies) and hands each part its slots back
    (the return ``all_to_all``).  The reference's TP ``psum`` over
    ``d_expert`` has nothing to sum: the weights are whole.  ``aux`` is
    the mean of the parts' losses (``pmean`` over the token axes).  Each
    call adds one to ``ep_calls``."""
    global ep_calls
    ep_calls += 1
    m = cfg.moe
    ep_ax = ctx.moe_ep_axis()
    owners = ctx.mesh.positions(ep_ax)
    n_ep = len(owners)
    e_loc = E // n_ep
    holders = (ctx.mesh.positions(token_axes if len(token_axes) > 1
                                  else token_axes[0])
               if token_axes else (ctx.device,))
    parts = [to(xp.contiguous(), dev) for xp, dev in
             zip(torch.chunk(xt, len(holders), dim=0), holders)]
    routes, slots, sent = [], [], []
    for j, (xp, dev) in enumerate(zip(parts, holders)):
        with at(holders, j):
            r = _route(xp, to(p["router"], dev), m, E, C)
            xe, st = _dispatch_gather(xp, r, E, C)         # (n_l, E, C, d)
        routes.append(r)
        slots.append(st)
        sent.append(xe.transpose(0, 1))                    # (E, n_l, C, d)
    got = []
    for i, dev in enumerate(owners):
        with at(owners, i):
            # owner i's experts' slots from every part, side by side
            xe_i = torch.cat([to(s[i * e_loc:(i + 1) * e_loc], dev)
                              for s in sent], dim=1)       # (E/n, Σn_l, C, d)
            exp_i = {k: to(w[i * e_loc:(i + 1) * e_loc], dev)
                     for k, w in p["experts"].items()}
            ye_i = _expert_ffn(xe_i.reshape(1, e_loc, -1, xe_i.shape[-1]),
                               exp_i, cfg.mlp_type)
            got.append(ye_i.reshape(xe_i.shape))
    ys, auxes, off = [], [], 0
    for j, (xp, dev, r, st) in enumerate(zip(parts, holders, routes,
                                             slots)):
        n_l = xp.shape[0]
        with at(holders, j):
            ye = torch.cat([to(y[:, off:off + n_l], dev) for y in got],
                           dim=0).transpose(0, 1)           # (n_l, E, C, d)
            off += n_l
            ys.append(to(_combine_gather(ye.contiguous(), r, st, E, C),
                         xt.device))
            auxes.append(to(_aux_loss(r, E), xt.device))
    return torch.cat(ys, dim=0), torch.stack(auxes).mean()

