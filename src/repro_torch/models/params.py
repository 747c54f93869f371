"""Parameter shapes, seeded initialisation, and the bridge from the
reference's parameter tree.

The tree mirrors the reference: ``{"embed", "final_norm", "unembed",
"blocks": {pattern position: {name: (n_blocks, ...)}}}`` with each pattern
position's parameters stacked over a leading ``n_blocks`` axis; learned
positions add ``pos_emb``, and an encoder-decoder (Whisper) adds the cross
attention leaves (``normx``, ``x_wq``...) to its decoder layers and an
``encoder`` tree ``{"blocks": {"0": ...}, "final_norm", "pos_emb"}``.  Matrices
are stored in ``cfg.dtype`` (the reference keeps fp32 and casts at every
call; casting once at load gives the same numbers).  Norm scales and the
SSM's per-head ``dt_bias``, ``A_log`` and ``D``, which the reference reads
in fp32 whatever the compute type, are kept in fp32.

``param_specs(cfg, ctx)`` gives each leaf's placement on the reference's
mesh as a tuple of axis names a dim (``P(None, "data", "model")`` is
``(None, "data", "model")``; ``()`` is replicated), the 2-D rule under
``ctx.shard2d_weights`` included, and ``abstract_params(cfg, dtype)`` the
tree as ``TensorSpec`` records, every leaf at ``dtype`` as in the
reference (params.py:249).  They describe the reference's placement: the
port itself keeps every weight whole on position 0 of its mesh
(``launch/dryrun.py`` counts it so).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import TensorSpec
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.sharding import ExecContext, resolve_device


def _attn_shapes(cfg: ModelConfig, prefix: str = "") -> dict:
    d, dh = cfg.d_model, cfg.head_dim_
    hp, kv = cfg.padded_heads, cfg.n_kv_heads
    s = {"wq": (d, hp * dh), "wk": (d, kv * dh), "wv": (d, kv * dh),
         "wo": (hp * dh, d)}
    if cfg.qkv_bias:
        s.update({"bq": (hp * dh,), "bk": (kv * dh,), "bv": (kv * dh,)})
    return {prefix + k: v for k, v in s.items()}


def _mamba_shapes(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.ngroups * s.d_state
    return {"wz": (d, d_in), "wxbc": (d, conv_ch), "wdt": (d, H),
            "dt_bias": (H,), "A_log": (H,), "D": (H,),
            "conv_w": (s.d_conv, conv_ch), "conv_b": (conv_ch,),
            "norm": (d_in,), "wout": (d_in, d)}


def _ffn_shapes(cfg: ModelConfig, d_ff: int) -> dict:
    d = cfg.d_model
    s = {"wi": (d, d_ff), "wo": (d_ff, d)}
    if cfg.mlp_type == "swiglu":
        s["wg"] = (d, d_ff)
    return s


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    s = {"norm1": (d,)}
    s.update(_attn_shapes(cfg) if spec.mixer == "attn"
             else _mamba_shapes(cfg))
    if spec.cross_attn:
        s["normx"] = (d,)
        s.update(_attn_shapes(cfg, prefix="x_"))
    if spec.ffn != "none":
        s["norm2"] = (d,)
        if spec.ffn == "moe":
            # routed experts stacked over a leading E; the shared experts
            # as one always-on MLP of n_shared * d_shared
            m = cfg.moe
            moe = {"router": (d, m.n_experts),
                   "experts": {k: (m.n_experts,) + v for k, v in
                               _ffn_shapes(cfg, m.d_expert).items()}}
            if m.n_shared:
                moe["shared"] = _ffn_shapes(cfg, m.n_shared * m.d_shared)
            s["moe"] = moe
        else:
            s["ffn"] = _ffn_shapes(cfg, cfg.d_ff)
    return s


def _stack(tree: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in tree.items()}


def param_shapes(cfg: ModelConfig) -> dict:
    """Shapes of the parameter tree (reference params.py:80)."""
    d = cfg.d_model
    shapes = {"embed": (cfg.padded_vocab, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.padded_vocab, d)
    if cfg.pos_embedding == "learned":
        shapes["pos_emb"] = (min(cfg.max_position, 1 << 16), d)
    shapes["blocks"] = {str(i): _stack(_layer_shapes(cfg, spec), cfg.n_blocks)
                        for i, spec in enumerate(cfg.pattern)}
    if cfg.encoder_decoder:
        enc = _layer_shapes(cfg, LayerSpec(mixer="attn", ffn="dense"))
        shapes["encoder"] = {
            "blocks": {"0": _stack(enc, cfg.n_encoder_layers)},
            "final_norm": (d,),
            "pos_emb": (min(cfg.max_position, 1 << 16), d)}
    return shapes


# ------------------------------------------------------------------- specs
def _matrix_spec(key: str, shape: tuple, cfg: ModelConfig,
                 ctx: ExecContext) -> tuple:
    """Sharding rule per parameter name, on its unstacked shape
    (reference params.py:109).  With ``ctx.shard2d_weights`` the dim that
    TP leaves whole splits over the data axis too (2-D weight sharding
    for small-batch decode)."""
    tp = ctx.tp_axis
    if tp is None or ctx.mesh is None:
        return ()
    n = ctx.axis_size(tp)
    dp = None
    if ctx.shard2d_weights:
        # the data axis, whether or not the batch splits over it
        # (long_500k has batch 1)
        cand = ctx.dp_axis or ("data" if "data" in ctx.mesh.axis_names
                               else None)
        if cand is not None and ctx.axis_size(cand) > 1:
            dp = cand

    def t(dim):
        return tp if dim % n == 0 else None

    def d(dim):
        return dp if dp is not None and dim % ctx.axis_size(dp) == 0 \
            else None

    if key in ("embed", "unembed"):
        return (t(shape[0]), d(shape[1]))
    if key == "pos_emb":
        return ()
    base = key[2:] if key.startswith("x_") else key
    if base == "wq":
        return (d(shape[0]), t(shape[-1]))
    if base in ("wk", "wv"):
        return (d(shape[0]), tp if cfg.n_kv_heads % n == 0 else None)
    if base in ("wo", "wout"):
        return (t(shape[-2]), d(shape[-1]))
    if base in ("wi", "wg"):
        if len(shape) == 3:                    # stacked expert (E, d, f)
            return (None, d(shape[-2]), t(shape[-1]))
        return (d(shape[0]), t(shape[-1]))
    if base == "wz":
        return (d(shape[0]), t(shape[-1]))
    if base == "wxbc" and dp is not None and len(shape) == 2:
        return (d(shape[0]), None)
    return ()                                  # norms, router, conv, small


def param_specs(cfg: ModelConfig, ctx: ExecContext) -> dict:
    """Each leaf's placement on the reference's mesh, a tuple of axis
    names (or None) a dim, stacked leaves with a leading None (reference
    params.py:166)."""
    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        key = path[-1]
        stacked = path[0] in ("blocks", "encoder")
        base = tree[1:] if stacked else tree
        spec = _matrix_spec(key, base, cfg, ctx)
        if key == "wo" and len(base) == 3:          # expert wo (E, f, d)
            n = ctx.axis_size(ctx.tp_axis)
            spec = ((None, ctx.tp_axis, None)
                    if ctx.tp_axis and base[1] % n == 0 else ())
        return (None,) + spec if stacked else spec

    return walk(param_shapes(cfg))


def abstract_params(cfg: ModelConfig, dtype: str = "bfloat16") -> dict:
    """The parameter tree as ``TensorSpec`` records, every leaf at
    ``dtype`` (reference params.py:249); nothing is allocated."""
    dt = getattr(torch, dtype)
    return _map_tree(param_shapes(cfg), lambda _, sh: TensorSpec(sh, dt))


def _is_fp32(name: str) -> bool:
    return (name.startswith("norm") or name == "final_norm"
            or name in ("dt_bias", "A_log", "D"))


def _map_tree(shapes: dict, fn, path=()) -> dict:
    return {k: (_map_tree(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in shapes.items()}


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: Optional[str] = None) -> dict:
    """Seeded initialisation on ``device`` with the reference's rules
    (params.py:188): norms and the SSM skip ``D`` at one, biases and
    ``conv_b`` at zero, ``dt_bias`` so that softplus(dt_bias) spans
    [1e-3, 1e-1] log-uniformly, ``A_log = log(U(1, 16))``, every other
    tensor normal with std ``1/sqrt(fan_in)`` (fan_in = second-to-last
    dim of the stacked shape; the cross-attention biases ``x_b*`` do not
    start with "b" and so are drawn too, as in the reference).  Torch's generator does not reproduce the reference's numbers;
    tests bridge the reference's tree with ``params_from_numpy`` instead.
    Padded query heads (``cfg.pad_heads_to``) are zeros in ``wq`` and
    ``wo``.  ``device`` defaults to CUDA (raising without a card)."""
    device = resolve_device(device)
    dt = getattr(torch, dtype or cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = _map_tree(param_shapes(cfg), lambda path, shape: init_leaf(
        path, shape, dt, device, gen))
    zero_padded_heads(cfg, params)
    return params


def init_leaf(path: tuple, shape: tuple, dt: torch.dtype, device,
              gen: torch.Generator) -> torch.Tensor:
    """One leaf of ``init_params`` by its name (``path[-1]``): matrices
    at ``dt``, norms and the SSM scalars in fp32."""
    f32 = torch.float32
    name = path[-1]

    def uniform(lo, hi):
        return torch.empty(shape, dtype=f32, device=device).uniform_(
            lo, hi, generator=gen)

    if name == "dt_bias":
        u = uniform(math.log(1e-3), math.log(1e-1))
        return torch.log(torch.expm1(torch.exp(u)))
    if name == "A_log":
        return torch.log(uniform(1.0, 16.0))
    if _is_fp32(name):                          # norms and D
        return torch.ones(shape, dtype=f32, device=device)
    if name.startswith("b") or name == "conv_b":
        return torch.zeros(shape, dtype=dt, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=dt, device=device)
    return w.normal_(0.0, std, generator=gen)


def zero_padded_heads(cfg: ModelConfig, params: dict) -> None:
    """Zero the padded query heads (phi4: 24 -> 32) in place, their wq
    columns and wo rows, so that they are inert."""
    dh = cfg.head_dim_
    for idx in padded_head_indices(cfg):
        for i, spec in enumerate(cfg.pattern):
            if spec.mixer == "attn":
                blk = params["blocks"][str(i)]
                blk["wq"][..., idx * dh:(idx + 1) * dh] = 0
                blk["wo"][..., idx * dh:(idx + 1) * dh, :] = 0


def padded_head_indices(cfg: ModelConfig) -> list:
    """Indices (in the padded head axis) of the inert zero pads
    (reference params.py:240).  Pads are interleaved per KV group — each
    group of n_heads / n_kv real heads is padded to padded_heads / n_kv —
    so the GQA mapping ``h // group`` of the real heads is unchanged."""
    if not cfg.pad_heads_to or cfg.pad_heads_to <= cfg.n_heads:
        return []
    kv = cfg.n_kv_heads
    if cfg.n_heads % kv or cfg.pad_heads_to % kv:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads padded to "
                         f"{cfg.pad_heads_to} over {kv} KV heads")
    rg, pg = cfg.n_heads // kv, cfg.pad_heads_to // kv
    return [g * pg + j for g in range(kv) for j in range(rg, pg)]


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameter tree (numpy arrays, same keys and shapes)
    as the port's on ``device`` (default CUDA): matrices cast once to
    ``cfg.dtype``, norms and the SSM's dt_bias/A_log/D in fp32."""
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    shapes = param_shapes(cfg)

    def conv(path, shape):
        a = tree
        for k in path:
            a = a[k]
        a = np.array(a, np.float32)          # a writable host copy
        if a.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {a.shape} != {shape}")
        t = torch.from_numpy(a).to(device)
        return t if _is_fp32(path[-1]) else t.to(dt)

    return _map_tree(shapes, conv)


def count_params(params: dict) -> int:
    return sum(v.numel() if isinstance(v, torch.Tensor) else count_params(v)
               for v in params.values())
