"""Roofline terms of a step on the H100's terms (reference
``launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds, for one position:

    compute    = flops_per_position / PEAK_FLOPS
    memory     = bytes_accessed_per_position / HBM_BW
    collective = collective_bytes_per_position / LINK_BW

The reference reads the first two from XLA's cost analysis of the
compiled per-device program and parses the collectives out of its HLO.
The port has no compiler between the step and the card: the dry run
(``launch/dryrun.py``) counts the flops and bytes of every aten op the
step runs, and the mesh records its collectives (``launch.mesh
.recording_collectives``).  ``collective_bytes`` applies the reference's
wire formulas to those records.

``model_flops`` (useful work of the whole step, every position together)
is the reference's, unchanged:
    train   : 6 * N_active * tokens + attention pair-work (fwd+bwd)
    prefill : 2 * N_active * tokens + attention pair-work
    decode  : 2 * N_active * batch + batch * cache * attn pair cost
Its ratio to the counted flops exposes recompute, MoE dispatch overhead,
padded heads and, on the plain path, the causal half of the scores that
the plain attention computes and masks.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Iterable, Optional

from repro_torch.models.config import InputShape, ModelConfig

# NVIDIA H100 80GB HBM3 (SXM), the card of 700.00 W power limit: published
# dense bf16 tensor-core peak, HBM3 bandwidth, NVLink 4 bandwidth each way
PEAK_FLOPS = 989e12          # bf16 dense / card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, each way


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """One position's wire bytes of a collective over ``n`` positions
    whose result on that position is ``result_bytes`` (ring algorithms,
    reference roofline.py:81-118):
      all-gather          res * (n-1)/n     (result = gathered whole)
      all-reduce          2 * res * (n-1)/n (result == operand)
      reduce-scatter      res * (n-1)       (result = one shard)
      all-to-all          res * (n-1)/n
      collective-permute  res
    and the port's ``split`` of a whole tensor held by one position,
      scatter             res * (n-1)/n     (result = the whole)."""
    if kind in ("all-gather", "all-to-all", "scatter"):
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"collective kind {kind!r}")


def collective_bytes(records: Iterable[dict]) -> Dict[str, float]:
    """Per-position wire bytes by collective kind, from records
    {"kind", "result_bytes", "group"}, plus their ``"total"``."""
    out: Dict[str, float] = {}
    for r in records:
        k = r["kind"]
        out[k] = out.get(k, 0.0) + float(
            wire_bytes(k, r["result_bytes"], r["group"]))
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Useful (algorithmic) FLOPs for the whole step, all positions
    together (reference roofline.py:121)."""
    n_active = cfg.active_param_count()
    d = cfg.d_model
    attn_layers = sum(1 for s in cfg.pattern if s.mixer == "attn") \
        * cfg.n_blocks
    B, S = shape.global_batch, shape.seq_len
    window = cfg.sliding_window or cfg.long_context_window

    def attn_pairs(q_tokens, kv_tokens, causal=True):
        if window is not None and shape.name == "long_500k":
            kv_tokens = min(kv_tokens, window)
        pairs = q_tokens * kv_tokens
        return pairs / 2 if causal and q_tokens == kv_tokens else pairs

    if shape.kind == "train":
        tokens = B * S
        fl = 6.0 * n_active * tokens
        fl += 3 * 4.0 * d * attn_layers * B * attn_pairs(S, S)
        return fl
    if shape.kind == "prefill":
        tokens = B * S
        fl = 2.0 * n_active * tokens
        fl += 4.0 * d * attn_layers * B * attn_pairs(S, S)
        return fl
    # decode: one token per sequence, full-cache attention read
    fl = 2.0 * n_active * B
    kv = S if window is None else min(S, window)
    fl += 4.0 * d * attn_layers * B * kv
    return fl


@dataclass
class Roofline:
    """The reference's record, its per-device fields for the busiest
    position of the port's mesh (``hlo_*`` keep their names: they hold
    the dry run's counts of the plain path's aten ops)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    coll_bytes_per_dev: float
    peak_mem_per_dev: float
    compute_s: float
    memory_s: float          # bytes accessed / HBM bw
    memory_adj_s: float      # (arguments + temporaries) / HBM bw
    collective_s: float
    model_flops_total: float
    useful_ratio: float
    bottleneck: str          # from (compute, memory_adj, collective)
    bottleneck_hlo: str      # from (compute, memory, collective)
    coll_detail: Optional[dict] = None

    def to_dict(self) -> dict:
        return asdict(self)


def analyse(arch: str, shape: InputShape, mesh_name: str, chips: int,
            cfg: ModelConfig, cost: dict, peak_mem: float = 0.0,
            coll: Optional[dict] = None) -> Roofline:
    """The roofline of a step from its counted ``cost`` ({"flops",
    "bytes accessed"} of one position) and ``coll`` (``collective_bytes``
    of its records, or None for none)."""
    flops = float(cost.get("flops", 0.0))
    mem_bytes = float(cost.get("bytes accessed", 0.0))
    coll = dict(coll or {"total": 0.0})
    compute_s = flops / PEAK_FLOPS
    memory_s = mem_bytes / HBM_BW
    memory_adj_s = peak_mem / HBM_BW
    collective_s = coll["total"] / LINK_BW
    terms_adj = {"compute": compute_s, "memory": memory_adj_s,
                 "collective": collective_s}
    terms_raw = {"compute": compute_s, "memory": memory_s,
                 "collective": collective_s}
    mf = model_flops(cfg, shape)
    ratio = mf / (flops * chips) if flops > 0 else float("nan")
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops_per_dev=flops, hlo_bytes_per_dev=mem_bytes,
        coll_bytes_per_dev=coll["total"], peak_mem_per_dev=peak_mem,
        compute_s=compute_s, memory_s=memory_s, memory_adj_s=memory_adj_s,
        collective_s=collective_s,
        model_flops_total=mf, useful_ratio=ratio,
        bottleneck=max(terms_adj, key=terms_adj.get),
        bottleneck_hlo=max(terms_raw, key=terms_raw.get),
        coll_detail={k: v for k, v in coll.items() if k != "total"})
