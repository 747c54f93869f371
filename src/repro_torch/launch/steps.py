"""Step functions of the reference's input shapes, their placements and
their abstract inputs (reference ``launch/steps.py``).

One builder per input-shape kind: the train step (forward, backward,
AdamW), the prefill step (ring-attention SP prefill -> last-position
logits + KV) and the decode step (one token against the KV cache).
``build_step`` returns ``(fn, placements, abstract_args)``: ``fn`` the
step, ``abstract_args`` its inputs as ``TensorSpec`` trees
(``configs/registry.input_specs``), ``placements`` the reference's
sharding of each leaf as a tuple of axis names a dim (a PartitionSpec as
a tuple; one axis where the reference names one, a tuple of axes where it
collapses several).  Nothing is allocated.

``make_args`` turns the abstract inputs into tensors: on ``"meta"`` for
the dry run (``launch/dryrun.py``), or on a device from a seeded
``torch.Generator`` for a run on the card.  It lays the inputs out as the
port runs them: every leaf whole on position 0 of the mesh, except a
decode step's attention caches whose sequence dim the placement splits,
which become per-position sequence shards (``core.cdsp
.shard_dense_caches``' layout) for the split-KV decode.  Values that the
port's forward reads out of a tensor follow from the shape: a decode
step's ``cache_len`` and position are ``seq_len - 1``, a prefill's
positions ``0..seq_len-1``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.registry import TensorSpec, cache_specs, input_specs
from repro_torch.launch.mesh import make_context
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.params import (abstract_params, init_leaf,
                                       param_shapes, param_specs,
                                       zero_padded_heads)
from repro_torch.models.sharding import ExecContext
from repro_torch.models.transformer import forward
from repro_torch.training.optimizer import AdamW, AdamWState


def _ax(axes):
    """An axis tuple as a PartitionSpec entry: None, the one axis, or
    the tuple (PartitionSpec makes a one-axis tuple its axis)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def scanned_param_bytes_per_dev(cfg: ModelConfig, mesh,
                                dtype_bytes: int = 2,
                                ctx_overrides: Optional[dict] = None
                                ) -> int:
    """Per-device bytes of the layer-stack parameters ("blocks",
    "encoder") under the reference's placement on ``mesh`` (reference
    steps.py:28; it sizes the stack the reference's scan carries).
    ``ctx_overrides`` (a dry-run variant's, ``shard2d_weights`` among
    them) apply to the placement; the reference's takes none."""
    ctx = make_context(mesh, "prefill").with_(**(ctx_overrides or {}))
    shapes, specs = param_shapes(cfg), param_specs(cfg, ctx)

    def walk(sh, sp):
        if isinstance(sh, dict):
            return sum(walk(sh[k], sp[k]) for k in sh)
        shard = math.prod(mesh.shape[a] for e in sp for a in _axes(e))
        return math.prod(sh) * dtype_bytes // shard

    return sum(walk(shapes[k], specs[k]) for k in ("blocks", "encoder")
               if k in shapes)


def _pos_spec(cfg: ModelConfig, batch_axes, seq_axis) -> tuple:
    if cfg.rope_type == "mrope":
        return (None, batch_axes, seq_axis)
    return (batch_axes, seq_axis)


def _cache_spec_tree(cfg: ModelConfig, ctx: ExecContext) -> dict:
    """Placements matching ``configs.registry.cache_specs``' tree
    (reference steps.py:77)."""
    n_model = ctx.axis_size(ctx.tp_axis)
    ba, split = _ax(ctx.batch_axes), ctx.kv_split_axis
    out = {}
    for i, spec in enumerate(cfg.pattern):
        c = {}
        if spec.mixer == "attn":
            kv = (None, ba, split, None, None)
            c["self"] = {"k": kv, "v": kv}
        else:
            s = cfg.ssm
            H = s.expand * cfg.d_model // s.head_dim
            h_ax = ctx.tp_axis if H % n_model == 0 else None
            c["self"] = {"conv": (None, ba, None, None),
                         "ssm": (None, ba, h_ax, None, None)}
        if spec.cross_attn:
            c["cross"] = {"k": (None, ba, None, None, None),
                          "v": (None, ba, None, None, None)}
        out[str(i)] = c
    return out


def decode_context(mesh, shape: InputShape, cfg: ModelConfig,
                   impl: Optional[str] = None) -> ExecContext:
    """The decode context (reference steps.py:100): the batch on "data"
    and the KV split over "model"; a batch smaller than the "data" axis
    (long_500k's one sequence) splits the KV over both axes."""
    pod = "pod" if "pod" in mesh.axis_names else None
    window = cfg.long_context_window if shape.name == "long_500k" else None
    if shape.global_batch >= mesh.shape["data"]:
        return ExecContext(mesh=mesh, dp_axis="data", tp_axis="model",
                           kv_split_axis="model", pod_axis=pod, impl=impl,
                           window=window)
    return ExecContext(mesh=mesh, dp_axis=None, tp_axis="model",
                       kv_split_axis=("data", "model"),
                       pod_axis=pod if shape.global_batch >= 2 else None,
                       impl=impl, window=window)


def build_step(cfg: ModelConfig, shape: InputShape, mesh,
               impl: Optional[str] = None, dtype: str = "bfloat16",
               ctx_overrides: Optional[dict] = None):
    """Returns ``(fn, placements, abstract_args)``; ``fn(*args)`` runs the
    step on the port (reference steps.py:116).

    Torch refuses a product of two dtypes, so each step computes at its
    parameters' dtype, where the reference casts them to ``cfg.dtype`` at
    every product: ``dtype`` (the prefill and decode steps; the
    published configs' own), fp32 for the train step, whose parameters
    are fp32 as the reference's."""
    specs = input_specs(cfg, shape, dtype=dtype)
    run_cfg = dataclasses.replace(cfg, dtype=dtype)
    pod = "pod" if "pod" in mesh.axis_names else None
    ov = dict(ctx_overrides or {})

    if shape.kind == "train":
        from repro_torch.training.train_loop import (make_train_step,
                                                     trainable)
        ctx = make_context(mesh, "train", impl=impl).with_(**ov)
        ba = _ax(ctx.batch_axes)
        params = abstract_params(cfg, dtype="float32")
        p_specs = param_specs(cfg, ctx)
        opt = AdamW()
        opt_state = AdamWState(step=TensorSpec((), torch.int32),
                               mu=params, nu=params)
        o_specs = AdamWState(step=(), mu=p_specs, nu=p_specs)
        step = make_train_step(dataclasses.replace(cfg, dtype="float32"),
                               ctx, opt)

        def train_step(params, opt_state, batch):
            return step(trainable(params), opt_state, batch)

        batch_specs = {"tokens": (ba, None), "labels": (ba, None),
                       "positions": _pos_spec(cfg, ba, None)}
        batch_abs = {k: specs[k] for k in ("tokens", "labels", "positions")}
        if cfg.encoder_decoder:
            batch_specs["encoder_frames"] = (ba, ctx.tp_axis, None)
            batch_abs["encoder_frames"] = specs["encoder_frames"]
        return (train_step, (p_specs, o_specs, batch_specs),
                (params, opt_state, batch_abs))

    if shape.kind == "prefill":
        ctx = make_context(mesh, "prefill", impl=impl).with_(**ov)
        params = abstract_params(cfg, dtype=dtype)
        p_specs = param_specs(cfg, ctx)

        def prefill_step(params, batch):
            logits, _, caches = forward(
                params, run_cfg, ctx, batch["tokens"], batch["positions"],
                "prefill", encoder_frames=batch.get("encoder_frames"))
            return logits, caches

        if cfg.encoder_decoder:
            batch_specs = {"tokens": (pod, None),
                           "positions": _pos_spec(cfg, pod, None),
                           "encoder_frames": (pod, "data", None)}
        else:
            batch_specs = {"tokens": (pod, "data"),
                           "positions": _pos_spec(cfg, pod, "data")}
        batch_abs = {k: specs[k] for k in batch_specs}
        return prefill_step, (p_specs, batch_specs), (params, batch_abs)

    # ----------------------------------------------------------- decode
    ctx = decode_context(mesh, shape, cfg, impl=impl).with_(**ov)
    ba = _ax(ctx.batch_axes)
    params = abstract_params(cfg, dtype=dtype)
    p_specs = param_specs(cfg, ctx)
    cache_tree = _cache_spec_tree(cfg, ctx)
    cache_abs = specs["caches"]
    run_ctx = ctx
    window = ctx.window or cfg.sliding_window
    if ctx.ring_cache and window is not None and window < shape.seq_len:
        # ring-buffer SWA cache: the attention caches shrink to the window
        # and lose the sequence split; the port then decodes over the
        # whole ring on position 0, as the reference's ring branch does
        cache_abs = cache_specs(cfg, shape.global_batch, window, dtype)
        run_ctx = ctx.with_(kv_split_axis=None)
        cache_tree = _cache_spec_tree(cfg, run_ctx)

    def decode_step(params, batch):
        logits, _, caches = forward(
            params, run_cfg, run_ctx, batch["tokens"], batch["positions"],
            "decode", caches=batch["caches"], cache_len=batch["cache_len"])
        return logits, caches

    batch_specs = {"tokens": (ba, None),
                   "positions": _pos_spec(cfg, ba, None),
                   "cache_len": (ba,),
                   "caches": cache_tree}
    batch_abs = {k: specs[k] for k in ("tokens", "positions", "cache_len")}
    batch_abs["caches"] = cache_abs
    return decode_step, (p_specs, batch_specs), (params, batch_abs)


# ------------------------------------------------------------ materialise
def data_values(shape: InputShape) -> dict:
    """The values of the inputs the port's forward reads, as the input
    shape implies them."""
    last = shape.seq_len - 1
    if shape.kind == "decode":
        return {"cache_len": last, "positions": last}
    return {"positions": f"0..{last}"}


def _is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def make_args(cfg: ModelConfig, shape: InputShape, abstract_args,
              placements, mesh, device=None, seed: int = 0):
    """``abstract_args`` as tensors: ``(args, arg_bytes)``, ``arg_bytes``
    mapping each mesh position to the bytes placed on it.

    On ``"meta"`` nothing is allocated.  Elsewhere the values come from a
    ``torch.Generator`` seeded with ``seed``: parameters by
    ``models.params.init_leaf``'s rules (cast to the leaf's dtype),
    tokens and labels uniform over the vocabulary, encoder frames and
    cache leaves standard normal, the optimizer's state zero, positions
    and ``cache_len`` as ``data_values`` gives them.  Every leaf lies on
    position 0's device, except that a decode step's attention caches
    whose placement splits their sequence dim become lists of that dim's
    contiguous shards, shard i on position i of the split axes."""
    dev = torch.device(device if device is not None else mesh.devices[0])
    meta = dev.type == "meta"
    gen = None if meta else torch.Generator(device=dev).manual_seed(seed)
    arg_bytes: dict = {}

    def put(pos: int, t: torch.Tensor) -> None:
        arg_bytes[pos] = arg_bytes.get(pos, 0) + t.numel() * t.element_size()

    def leaf(path: tuple, spec: TensorSpec, place) -> object:
        name, sh, dt = path[-1], tuple(spec.shape), spec.dtype
        if meta:
            t = torch.empty(sh, dtype=dt, device=dev)
        elif path[0] == "params":
            t = init_leaf(path, sh, dt, dev, gen).to(dt)
        elif path[0] == "opt_state":
            t = torch.zeros(sh, dtype=dt, device=dev)
        elif name in ("tokens", "labels"):
            t = torch.randint(0, cfg.vocab_size, sh, generator=gen,
                              device=dev).to(dt)
        elif name == "positions":
            if shape.kind == "decode":
                t = torch.full(sh, shape.seq_len - 1, dtype=dt, device=dev)
            else:
                t = torch.arange(sh[-1], dtype=dt, device=dev).expand(
                    sh).contiguous()
        elif name == "cache_len":
            t = torch.full(sh, shape.seq_len - 1, dtype=dt, device=dev)
        else:
            t = torch.empty(sh, dtype=dt, device=dev).normal_(generator=gen)
        split = (path[0] == "batch" and "caches" in path
                 and name in ("k", "v") and path[-2] == "self"
                 and place[2] is not None)
        if not split:
            put(0, t)
            return t
        line = mesh.positions(place[2])
        parts = [p.contiguous().to(d) for p, d in
                 zip(torch.chunk(t, len(line), dim=2), line)]
        for i, p in zip(line.ids, parts):
            put(i, p)
        return parts

    def walk(tree, place, path):
        if _is_spec(tree):
            return leaf(path, tree, place)
        if isinstance(tree, AdamWState):
            return AdamWState(*(walk(t, p, path + (f,)) for t, p, f in
                                zip(tree, place, tree._fields)))
        return {k: walk(v, place[k], path + (k,)) for k, v in tree.items()}

    roots = ("params", "opt_state", "batch") if len(abstract_args) == 3 \
        else ("params", "batch")
    args = []
    for root, tree, place in zip(roots, abstract_args, placements):
        out = walk(tree, place, (root,))
        if root == "params" and not meta:
            zero_padded_heads(cfg, out)
        args.append(out)
    return tuple(args), arg_bytes
