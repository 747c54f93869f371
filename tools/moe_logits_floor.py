#!/usr/bin/env python3
"""How close an MoE model's serve logits can come to the plain path, on
one card.

    python3 tools/moe_logits_floor.py [--arch ARCH] [--seeds SEED ...]
        [--requests REQ ...]

ARCH is qwen2-moe-a2.7b (the default), mixtral-8x22b or
jamba-1.5-large-398b, at the depth phase serve runs it
(``chip_smoke.served_config``: Mixtral's 8 layers, Jamba's published
layers 0-4).

chip_smoke.py's serve phase replays the smoke's longest request (request
3: 6144 tokens as two 3072-token chunks, then one decode tick) through
Qwen1.5-MoE-A2.7B at full width in bf16 with weights from seed 0, once on
the kernel path and once on the plain path, and holds the three logits
rows to ``LOGIT_TOL["qwen2-moe-a2.7b"]``.  The two paths differ only in
attention (K1-K3 against the plain versions), but a bf16 ulp of attention
can flip a near-tied router choice and, through capacity, drop another
token.  This script replays the smoke's requests (REQ 0-3: 512, 2048,
4096 and 6144 tokens; default 3 2 1) with weights from each SEED (default
0 1) in other ways, and prints for each way every row's max |err| and
cosine against the plain path, whether the row passes the smoke's limit,
and how many routing decisions differ from the plain path's (summed over
layers); with ``--against mesh_ep_plain`` each way is held instead to the
plain path of the 4-position mesh with expert parallelism:

  plain           the plain path itself (the replay's own spread);
  plain_ulp       the plain path with every attention output moved one
                  bf16 ulp toward zero;
  routed          the kernel path (what the smoke compares);
  mesh            the kernel path on the smoke's 4-position mesh of the
                  one card (ring attention, split-KV paged decode);
  mesh_ep         the same with expert parallelism (chip_smoke.py's
                  sp_families phase);
  planted_no_history  the kernel path with K2's partial left out of the
                  merge: the second chunk attends to its own keys only;
  planted_router_shift  the kernel path with every top-k choice moved to
                  the next expert;
  mesh_ep_planted_router_shift  the same on mesh_ep.

The mesh ways run on Qwen only (the default ways of the other
architectures leave them out).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import nvcc_variants as nv  # noqa: E402  (tools/, beside this script)

ROWS = ("chunk1", "chunk2_history", "decode_tick")


def _one_ulp_down(o):
    """Every nonzero bf16 element one ulp toward zero (its bit pattern
    less one, in either sign)."""
    import torch
    bits = o.view(torch.int16)
    return torch.where(o != 0, bits - 1, bits).view(torch.bfloat16)


def main(argv=None) -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b",
                    choices=["qwen2-moe-a2.7b", "mixtral-8x22b",
                             "jamba-1.5-large-398b"])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--requests", type=int, nargs="*", default=[3, 2, 1])
    ap.add_argument("--ways", nargs="*", default=None,
                    help="a subset of the ways (default: all)")
    ap.add_argument("--against", choices=["plain", "mesh_ep_plain"],
                    default="plain",
                    help="the replay every way is held to: the plain path "
                         "(default), or the plain path of the mesh with "
                         "expert parallelism (the same program as mesh_ep, "
                         "plain kernels)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_logits_floor: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"nvidia_smi": nv.nvidia_smi()}), flush=True)
    tol = chip_smoke.LOGIT_TOL[args.arch]
    kept = {"ops": {n: getattr(ops, n) for n in (
        "attention", "paged_prefill_attention", "paged_decode_attention")},
        "moe": {"top_k_stable": moe.top_k_stable}}

    def ulp_attention():
        a, pp, pd = (kept["ops"][n] for n in (
            "attention", "paged_prefill_attention",
            "paged_decode_attention"))

        def paged_decode(*args, **kw):
            o, *rest = pd(*args, **kw)
            return (_one_ulp_down(o), *rest)

        return {"ops": {
            "attention": lambda *x, **kw: _one_ulp_down(a(*x, **kw)),
            "paged_prefill_attention":
                lambda *x, **kw: _one_ulp_down(pp(*x, **kw)),
            "paged_decode_attention": paged_decode}}

    def no_history(q, k_new, v_new, q_pos, kv_pos_new, *pool_args,
                   causal=True, window=None, softmax_scale=None, impl=None):
        out, _ = fa.flash_attention(q, k_new, v_new, q_pos, kv_pos_new,
                                    causal=causal, window=window,
                                    softmax_scale=softmax_scale)
        return out

    def router_shift(x, k):
        vals, idx = kept["moe"]["top_k_stable"](x, k)
        return vals, (idx + 1) % x.shape[-1]

    # way -> (the context: plain, kernel or a mesh's, patches)
    ways = {"plain": (True, {}), "plain_ulp": (True, ulp_attention()),
            "routed": (False, {}), "mesh": ("mesh", {}),
            "mesh_ep": ("mesh_ep", {}),
            "planted_no_history": (False, {"ops": {
                "paged_prefill_attention": no_history}}),
            "planted_router_shift": (False, {"moe": {
                "top_k_stable": router_shift}}),
            "mesh_ep_planted_router_shift": ("mesh_ep", {"moe": {
                "top_k_stable": router_shift}})}
    modules = {"ops": ops, "moe": moe}
    if args.ways:
        ways = {n: w for n, w in ways.items() if n in args.ways}
    elif args.arch != "qwen2-moe-a2.7b":
        ways = {n: w for n, w in ways.items() if "mesh" not in n}
    cfg, cut = chip_smoke.served_config(args.arch)
    print(json.dumps({"arch": args.arch, "depth_cut": cut}), flush=True)
    n_moe = chip_smoke.count_layers(cfg, ffn="moe")
    ctx = make_context("cuda")
    plain = ctx.with_(impl="ref")
    mesh = chip_smoke._sp_context()
    ctxs = {True: plain, False: ctx, "mesh": mesh,
            "mesh_ep": mesh.with_(moe_ep=True)}
    against = (plain if args.against == "plain"
               else mesh.with_(moe_ep=True, impl="ref"))
    # the serve phase's prompts
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in (512, 2048, 4096, 6144)]
    for seed in args.seeds:
        params = init_params(cfg, seed=seed, device=ctx.device)
        for req in args.requests:
            prompt = prompts[req]
            # each request's decode token is the plain path's first
            token = int(torch.argmax(chip_smoke._replay(
                cfg, params, plain, prompt, [])[1]))
            with chip_smoke.moe_routes() as want_routes:
                want = chip_smoke._replay(cfg, params, against, prompt,
                                          [token])
            for name, (on_plain, patches) in ways.items():
                for mod, fns in patches.items():
                    for fn_name, fn in fns.items():
                        setattr(modules[mod], fn_name, fn)
                try:
                    with chip_smoke.moe_routes() as routes:
                        got = chip_smoke._replay(
                            cfg, params, ctxs[on_plain], prompt, [token])
                finally:
                    for mod, fns in kept.items():
                        for fn_name, fn in fns.items():
                            setattr(modules[mod], fn_name, fn)
                diff = chip_smoke.routing_diff(routes, want_routes, n_moe,
                                               ROWS)
                rows = {}
                for row, a, b in zip(ROWS, got, want):
                    err = float((a - b).abs().max())
                    cos = float(torch.nn.functional.cosine_similarity(
                        a, b, dim=0))
                    rows[row] = {"max_abs_err": err, "cos": cos,
                                 "passes": (err <= tol["max_abs_err"]
                                            and cos >= tol["cos"]),
                                 "topk_set_differs":
                                     sum(diff[row]["topk_set_differs"]),
                                 "keep_differs":
                                     sum(diff[row]["keep_differs"])}
                print(json.dumps({"arch": args.arch, "seed": seed,
                                  "request": req, "way": name,
                                  "against": args.against,
                                  "tokens": len(prompt),
                                  "logits_vs_plain": rows}), flush=True)
        del params
        chip_smoke._free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
