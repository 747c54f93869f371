"""Dry run: count every (architecture x input shape) step on the
production mesh and write its roofline terms on the H100's peaks
(reference ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--multi-pod] [--variant NAME] [--out DIR]

Nothing is allocated and no card is needed: the step of
``launch/steps.build_step`` runs on ``"meta"`` tensors, every position of
the (16, 16) mesh (``--multi-pod``: (2, 16, 16)) on the meta device.
The reference compiles the step and reads XLA's cost and memory
analyses; here the step runs the port's plain path (``impl=
"ref_blocked"``: meta tensors never reach a kernel) and a dispatch mode
counts each aten op it runs:

* flops — ``torch.utils.flop_counter.FlopCounterMode``'s formulas;
* bytes accessed — each op's tensor inputs read once and outputs written
  once, views free; an in-place op writes at most the bytes of its
  largest other input (the whole tensor when it has none but scalars).
  The ops are unfused, so this is the plain path's traffic, not what a
  fused kernel moves;
* memory — each new storage is live until the last tensor that views it
  dies; ``temp_bytes`` is the peak of the live bytes above the arguments
  (the step's outputs included);
* collectives — the mesh's records (``launch.mesh.recording_
  collectives``), in wire bytes by the reference's formulas
  (``launch.roofline.collective_bytes``).

Each count belongs to the mesh position whose work it is
(``launch.mesh.current_position``: an island names each position's body;
work outside the islands is position 0's, where the port runs it).  The
record gives the busiest position's numbers under the reference's
per-device names.  As the reference does, the step runs at 1 and 2
blocks and the full depth is extrapolated, ``c1 + (nb - 1)(c2 - c1)``;
temp bytes are the 2-block peak plus, for each further block, the growth
of the outputs it leaves live (a prefill's caches): a deeper stack's
peak repeats the second block's.  ``argument_bytes`` is what
``steps.make_args`` places on that position at full depth (the port
keeps every weight whole on position 0 under every variant, so the
counts of ``shard2d`` are those of ``ring_cache``), ``scanned_param_bytes``
the layer stack's bytes a device under the reference's placement with
the variant's overrides (``steps.scanned_param_bytes_per_dev``; the one
number ``shard2d_weights`` moves); the record's ``placement`` says so.
The reference's ``lower_s``/``compile_s``/``memory_analysis`` and its
TPU adjustment of temp bytes have no counterpart; ``count_s`` is the
counting runs' time.  The values the forward reads out of a tensor are
set from the shape (``steps.data_values``) and named in the record.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import NAMES, get_config, supports_shape
from repro_torch.launch.mesh import (current_position, make_production_mesh,
                                     recording_collectives)
from repro_torch.launch.roofline import analyse, collective_bytes
from repro_torch.launch.steps import (build_step, data_values, make_args,
                                      scanned_param_bytes_per_dev)
from repro_torch.models.config import INPUT_SHAPES

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
# the path counted: the plain one, attention a block of queries at a time
COUNTED_IMPL = "ref_blocked"
# what each byte count of a record is placed by: the port runs every
# variant with its weights whole on position 0, so a variant's placement
# (``shard2d_weights``) shows only in ``scanned_param_bytes``
PLACEMENT = {
    "argument_bytes": "the port's step: every weight whole on position 0, "
                      "whatever the variant",
    "scanned_param_bytes": "the reference's param_specs under the "
                           "variant's context (shard2d_weights included)"}
_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.layout, torch.memory_format)

VARIANTS = {
    "": {},
    "zigzag_skip": {"zigzag_skip": True},
    "window_slice": {"window_slice": True},
    "ring_cache": {"ring_cache": True},
    "moe_gather": {"moe_gather_dispatch": True},
    "shard2d": {"ring_cache": True, "shard2d_weights": True},
    "moe_ep": {"moe_ep": True},
    "optimized": {"zigzag_skip": True, "ring_cache": True},
}


def _tensors(tree) -> list:
    """The tensors of an op's arguments or outputs."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op reads of ``t``: its elements, at most its
    storage's (an expanded tensor reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, shared by its views."""
    return t.untyped_storage()._cdata


class StepCounter(TorchDispatchMode):
    """Per-position flops, bytes accessed and live bytes of the aten ops
    run under it; the flops by ``FlopCounterMode``'s formulas (its
    ``flop_registry``: matmuls, convolutions, attention).  ``arguments``
    are the step's inputs: their storages are not temporaries."""

    def __init__(self, arguments=()):
        super().__init__()
        self._formulas = FlopCounterMode(display=False).flop_registry
        self.flops = defaultdict(float)
        self.bytes = defaultdict(float)
        self.live = defaultdict(int)
        self.peak = defaultdict(int)
        self._args = {_key(t) for t in _tensors(arguments)}
        self._storages = {}          # key -> [views alive, nbytes, pos]
        self._memo = {}

    def _release(self, key) -> None:
        ent = self._storages.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live[ent[2]] -= ent[1]
            del self._storages[key]

    def _track(self, t: torch.Tensor, pos: int) -> None:
        key = _key(t)
        if key in self._args:
            return
        ent = self._storages.get(key)
        if ent is None:
            n = t.untyped_storage().nbytes()
            ent = self._storages[key] = [0, n, pos]
            self.live[pos] += n
            self.peak[pos] = max(self.peak[pos], self.live[pos])
        ent[0] += 1
        weakref.finalize(t, self._release, key)

    def _run(self, func, args, kwargs):
        """``func``'s output and flops.  A functional op with meta
        outputs (and no other tensor inputs) is run once per signature
        (op, input shapes, strides and dtypes, other arguments): the meta
        kernels are mostly Python and the islands repeat each op for
        every position, so later calls of a signature make empty meta
        outputs of the recorded layouts."""
        key = None
        if not func.is_view and not func._schema.is_mutable:
            sig = [tuple(kwargs)]
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, (list, tuple)):
                    sig.append(len(a))
                    items = a
                else:
                    items = (a,)
                for x in items:
                    if isinstance(x, torch.Tensor):
                        if x.device.type != "meta":
                            sig = None
                            break
                        sig.append((tuple(x.shape), x.stride(), x.dtype))
                    else:
                        sig.append(x if isinstance(x, _HASHABLE)
                                   else repr(x))
                if sig is None:
                    break
            key = None if sig is None else (func, tuple(sig))
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            spec, outs, flops = hit
            return tree_unflatten([
                torch.empty_strided(o[0], o[1], dtype=o[2], device="meta")
                if isinstance(o, tuple) else o for o in outs], spec), flops
        out = func(*args, **kwargs)
        formula = self._formulas.get(func.overloadpacket)
        flops = 0 if formula is None else \
            formula(*args, **kwargs, out_val=out)
        leaves, spec = tree_flatten(out)
        if key is not None and all(o.device.type == "meta" for o in leaves
                                   if isinstance(o, torch.Tensor)):
            self._memo[key] = (spec, [
                (tuple(o.shape), o.stride(), o.dtype)
                if isinstance(o, torch.Tensor) else o for o in leaves],
                flops)
        return out, flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out, flops = self._run(func, args, kwargs)
        pos = current_position()
        self.flops[pos] += flops
        outs = _tensors(out)
        if not func.is_view:
            written, read = [], []
            for a, v in zip(func._schema.arguments, args):
                if isinstance(v, torch.Tensor):
                    mut = a.alias_info is not None and a.alias_info.is_write
                    (written if mut else read).append(v)
            rb = [_nbytes(t) for t in read + _tensors(list(kwargs.values()))]
            wb = 0
            for t in written:
                big = max([b for b, r in zip(rb, read) if r.dim()],
                          default=None)
                wb += _nbytes(t) if big is None else min(_nbytes(t), big)
            mutated = {id(t) for t in written}
            wb += sum(_nbytes(t) for t in outs if id(t) not in mutated)
            self.bytes[pos] += sum(rb) + wb
        for t in outs:
            self._track(t, pos)
        return out


def count_step(cfg, shape, mesh, ctx_overrides=None) -> dict:
    """Run ``build_step``'s step once on meta tensors and count it:
    {"flops", "bytes accessed", "temp", "output"} each a dict position
    -> count, and "collectives" (``collective_bytes`` of the records)."""
    fn, place, abstract = build_step(cfg, shape, mesh, impl=COUNTED_IMPL,
                                     ctx_overrides=ctx_overrides)
    args, _ = make_args(cfg, shape, abstract, place, mesh, device="meta")
    with recording_collectives() as recs, \
            StepCounter(arguments=args) as sc:
        out = fn(*args)
        output = defaultdict(int)
        seen = set()
        for t in _tensors(out):
            key = _key(t)
            if key in sc._storages and key not in seen:
                seen.add(key)
                ent = sc._storages[key]
                output[ent[2]] += ent[1]
        del out
    return {"flops": dict(sc.flops), "bytes accessed": dict(sc.bytes),
            "temp": dict(sc.peak), "output": dict(output),
            "collectives": collective_bytes(recs)}


def _depth(cfg, n_blocks: int):
    return dataclasses.replace(
        cfg, n_layers=n_blocks * len(cfg.pattern),
        n_encoder_layers=(n_blocks if cfg.encoder_decoder else 0))


def _extrapolate(a: dict, b: dict, nb: int) -> dict:
    return {k: a.get(k, 0.0) + (nb - 1) * max(b.get(k, 0.0) - a.get(k, 0.0),
                                              0.0)
            for k in set(a) | set(b)}


def extrapolated_cost(cfg, shape, mesh, ctx_overrides=None) -> dict:
    """``count_step`` at 1 and 2 blocks, each count extrapolated to the
    config's depth (per position; the collectives per kind)."""
    c1 = count_step(_depth(cfg, 1), shape, mesh, ctx_overrides)
    c2 = count_step(_depth(cfg, 2), shape, mesh, ctx_overrides)
    nb = cfg.n_blocks
    out = {k: _extrapolate(c1[k], c2[k], nb)
           for k in ("flops", "bytes accessed", "output")}
    # a deeper stack's peak repeats the second block's (which holds what
    # the first left live) plus what each further block leaves live: its
    # share of the outputs (a prefill's caches)
    grow = {p: max(c2["output"].get(p, 0) - c1["output"].get(p, 0), 0)
            for p in set(c1["output"]) | set(c2["output"])}
    out["temp"] = c1["temp"] if nb == 1 else {
        p: c2["temp"].get(p, 0) + (nb - 2) * grow.get(p, 0)
        for p in set(c2["temp"]) | set(grow)}
    coll = _extrapolate({k: v for k, v in c1["collectives"].items()
                         if k != "total"},
                        {k: v for k, v in c2["collectives"].items()
                         if k != "total"}, nb)
    out["collectives"] = dict(coll, total=sum(coll.values()))
    return out


def step_record(cfg, shape, mesh, ctx_overrides=None) -> dict:
    """The busiest position's counts of a step on ``mesh`` at full
    depth: flops, bytes accessed, argument, temp and output bytes, the
    collectives' wire bytes, and the busiest position's share of every
    position's flops."""
    cost = extrapolated_cost(cfg, shape, mesh, ctx_overrides)
    _, place, abstract = build_step(cfg, shape, mesh, impl=COUNTED_IMPL,
                                    ctx_overrides=ctx_overrides)
    _, arg_bytes = make_args(cfg, shape, abstract, place, mesh,
                             device="meta")
    flops = cost["flops"]
    busiest = max(flops, key=flops.get) if flops else 0
    total = sum(flops.values())
    return {"position": busiest,
            "flops": flops.get(busiest, 0.0),
            "bytes accessed": cost["bytes accessed"].get(busiest, 0.0),
            "argument_bytes": arg_bytes.get(busiest, 0),
            "temp_bytes": int(cost["temp"].get(busiest, 0)),
            "output_bytes": int(cost["output"].get(busiest, 0)),
            "collectives": cost["collectives"],
            "positions_with_work": len([v for v in flops.values() if v]),
            "flops_share": flops.get(busiest, 0.0) / total if total else 0.0}


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            out_dir: str = RESULTS_DIR, verbose: bool = True,
            variant: str = "") -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant}
    if not supports_shape(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = "no sub-quadratic path for long_500k"
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    chips = len(mesh.devices)
    t0 = time.time()
    st = step_record(cfg, shape, mesh, VARIANTS[variant])
    count_s = time.time() - t0
    peak = st["argument_bytes"] + st["temp_bytes"]
    roof = analyse(arch, shape, mesh_name, chips, cfg,
                   {"flops": st["flops"],
                    "bytes accessed": st["bytes accessed"]},
                   peak_mem=peak, coll=st["collectives"])
    dtype_bytes = 4 if shape.kind == "train" else 2
    rec.update(
        status="ok", count_s=round(count_s, 1),
        counted=(f"plain path (impl={COUNTED_IMPL!r}), unfused aten ops "
                 "on meta tensors, 1 and 2 blocks extrapolated"),
        position=st["position"],
        positions_with_work=st["positions_with_work"],
        flops_share=st["flops_share"],
        argument_bytes=st["argument_bytes"], temp_bytes=st["temp_bytes"],
        scanned_param_bytes=scanned_param_bytes_per_dev(
            cfg, mesh, dtype_bytes=dtype_bytes,
            ctx_overrides=VARIANTS[variant]),
        placement=PLACEMENT,
        output_bytes=st["output_bytes"], data_values=data_values(shape),
        roofline=roof.to_dict())
    if verbose:
        tag = f" {variant}" if variant else ""
        print(f"[{arch} x {shape_name} x {mesh_name}{tag}] OK count "
              f"{count_s:.0f}s | position {st['position']} "
              f"({st['flops_share']:.2f} of the flops) | "
              f"compute {roof.compute_s*1e3:.2f}ms "
              f"mem {roof.memory_s*1e3:.2f}ms "
              f"mem(adj) {roof.memory_adj_s*1e3:.2f}ms "
              f"coll {roof.collective_s*1e3:.2f}ms -> {roof.bottleneck} | "
              f"useful {roof.useful_ratio:.2f} | args "
              f"{st['argument_bytes']/2**30:.2f} GiB temp "
              f"{st['temp_bytes']/2**30:.2f} GiB", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{variant}" if variant else ""
    fname = f"{arch}_{shape_name}_{mesh_name}{suffix}.json".replace("/", "_")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(NAMES))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every architecture and shape (also what a "
                         "missing --arch or --shape means)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="", choices=list(VARIANTS))
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = list(NAMES) if args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape is None else [args.shape]
    failures = []
    for a in archs:
        for s in shapes:
            try:
                rec = run_one(a, s, multi_pod=args.multi_pod,
                              out_dir=args.out, variant=args.variant)
                if rec["status"] == "skipped":
                    print(f"[{a} x {s}] SKIPPED: {rec['reason']}",
                          flush=True)
            except Exception as e:             # noqa: BLE001
                failures.append((a, s))
                print(f"[{a} x {s}] FAIL: {e}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         + ", ".join(f"{a}x{s}" for a, s in failures))
    print("dry-run complete: every combination counted.")


if __name__ == "__main__":
    main()
