#!/usr/bin/env python3
"""How close the Mamba-2 serve logits can come to the plain path, on one card.

    python3 tools/ssd_logits_floor.py [--seeds SEED ...] [--requests REQ ...]

chip_smoke.py's serve phase replays the smoke's longest request (request
3: 6144 tokens as two 3072-token chunks, then one decode tick) through
Mamba-2-1.3B at full width in bf16 with weights from seed 0, once on the
kernel path and once on the plain path, and holds the three logits rows
to max |err| <= 0.25 and cosine >= 0.998 (``LOGIT_TOL``).  The two paths
differ only in the SSD scan.  This script replays the smoke's requests
(REQ 0-3: 512, 2048, 4096 and 6144 tokens; default 3 2 1) with weights
from each SEED (default 0 1), with the scan computed other ways, and
prints for each way every row's max |err| and cosine against the plain
path, and whether the row passes the smoke's limit:

  plain        the plain scan itself (the replay's own spread: cosine 1);
  plain_ulp    the plain scan with y scaled by (1 - 2^-24), one fp32 ulp,
               before its bf16 rounding;
  routed       the port's K5 (bf16: the tensor-core kernels);
  routed_ulp   the port's K5 on fp32 copies of x, B and C (the CUDA-core
               kernels), y scaled by (1 - 2^-24) before its bf16 rounding;
  routed_c128  the port's K5 with 128-token chunks;
  exact        the chunked scan in float64, y rounded to bf16;
  planted_*    the plain scan with each of chip_smoke.SSD_FAULTS planted
               in the inputs of every call of the second chunk (h0
               dropped, x one token late, h0 of the wrong head): wrong
               scans, which the smoke's per-call gate rejects.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import nvcc_variants as nv  # noqa: E402  (tools/, beside this script)

ARCH = "mamba2-1.3b"


def main(argv=None) -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--requests", type=int, nargs="*", default=[3, 2, 1])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_logits_floor: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"nvidia_smi": nv.nvidia_smi()}), flush=True)
    routed, ulp = ops.ssd_scan, 1.0 - 2.0 ** -24
    tol = chip_smoke.LOGIT_TOL[ARCH]

    def plain_ulp(x, dt, A, Bm, Cm, *, h0=None, chunk=256):
        y, h = ref.ssd_chunked_ref(x.float(), dt, A, Bm, Cm, chunk=chunk,
                                   h0=h0, return_state=True)
        return (y * ulp).to(x.dtype), h

    def routed_ulp(x, dt, A, Bm, Cm, *, h0=None, chunk=256):
        y, h = routed(x.float(), dt, A, Bm.float(), Cm.float(), h0=h0,
                      chunk=chunk)
        return (y * ulp).to(x.dtype), h

    def routed_c128(x, dt, A, Bm, Cm, *, h0=None, chunk=256):
        return routed(x, dt, A, Bm, Cm, h0=h0, chunk=128)

    def exact(x, dt, A, Bm, Cm, *, h0=None, chunk=256):
        y, h = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                                   return_state=True, dtype=torch.float64)
        return y, h.float()

    def planted(fault):
        def scan(x, dt, A, Bm, Cm, *, h0=None, chunk=256):
            if h0 is None:
                return ops.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
            xf, hf = fault(x, h0)
            return ops.ssd_scan_plain(xf, dt, A, Bm, Cm, h0=hf, chunk=chunk)
        return scan

    ways = {"plain": ops.ssd_scan_plain, "plain_ulp": plain_ulp,
            "routed": routed, "routed_ulp": routed_ulp,
            "routed_c128": routed_c128, "exact": exact,
            **{f"planted_{k}": planted(f)
               for k, f in chip_smoke.SSD_FAULTS.items()}}
    cfg = get_config(ARCH)
    ctx = make_context("cuda")
    plain = ctx.with_(impl="ref")
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
                cfg, params, plain, prompt, 0)[1]))
            want = chip_smoke._replay(cfg, params, plain, prompt, token)
            for name, scan in ways.items():
                ops.ssd_scan = scan
                try:
                    got = chip_smoke._replay(cfg, params, ctx, prompt, token)
                finally:
                    ops.ssd_scan = routed
                rows = {}
                for row, a, b in zip(("chunk1", "chunk2_history",
                                      "decode_tick"), got, want):
                    err = float((a - b).abs().max())
                    cos = float(torch.nn.functional.cosine_similarity(
                        a, b, dim=0))
                    rows[row] = {"max_abs_err": err, "cos": cos,
                                 "passes": (err <= tol["max_abs_err"]
                                            and cos >= tol["cos"])}
                print(json.dumps({"seed": seed, "request": req,
                                  "scan": name, "logits_vs_plain": rows}),
                      flush=True)
        del params
    return 0


if __name__ == "__main__":
    sys.exit(main())
