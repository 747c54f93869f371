#!/usr/bin/env python3
"""A/B builds of K5's bf16 tensor-core kernels (``csrc/ssd_scan.cu``) on
one card.

    python3 tools/ssd_tc.py [RUN ...]

Each RUN is a build of the kept source with some lines replaced: a
VARIANT (another value of a tuning constant, or another CTA order), or a
PROBE, which leaves part of the work out to show what that part costs
(wrong results, times only).  Every build compiles with nvcc into
``src/repro_torch/kernels/build/variants/`` (all at once) and is loaded in
place of the port's library, so the runs go through the port's own
wrapper ``ssd_scan``.  Each run times the scan at the smoke's main shape
(a 3072-token Mamba-2-1.3B chunk: H 64, P 64, N 128, G 1, chunk 256, the
state handed in, x, B and C read in place from a fused projection):
device time in all and by kernel (torch.profiler, as chip_smoke.py times
it) and one call between its own events with a cold and a warm L2, and
prints them with K5's check ratios against the plain scan as one JSON
line.  Runs go in the order given (kept, variant, variant, kept share
one call and one card).  Exits nonzero if a variant disagrees.
"""

from __future__ import annotations

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import nvcc_variants as nv  # noqa: E402  (tools/, beside this script)

# source lines replaced in each variant (the kept source otherwise)
VARIANTS = {
    "kept": {},
    # heads per output CTA: 1 recomputes C.B^T for every head (the second
    # warpgroup of the CTA then has no head), 2-16 share it
    "heads1": {"HEADS": "1"},
    "heads2": {"HEADS": "2"},
    "heads4": {"HEADS": "4"},
    "heads16": {"HEADS": "16"},
    # heads per state CTA, sharing the chunk's B
    "sheads2": {"SHEADS": "2"},
    "sheads4": {"SHEADS": "4"},
    "sheads8": {"SHEADS": "8"},
    # output CTAs ordered row tile fastest (the four row tiles of a chunk
    # and head block side by side) instead of longest row tiles first
    "tile_fastest": {
        "order": [(r"const int c = blockIdx.x, hb = blockIdx.y;\n"
                   r"  const int bg = blockIdx.z % \(p.B \* p.G\);",
                   "const int c = blockIdx.x / nit, hb = blockIdx.y;\n"
                   "  const int bg = blockIdx.z;"),
                  (r"const int it = nit - 1 - static_cast<int>\(blockIdx.z\)"
                   r" / \(p.B \* p.G\);",
                   "const int it = nit - 1 - blockIdx.x % nit;"),
                  (r"dim3\(p.nc, nhb, nit \* p.B \* p.G\)",
                   "dim3(p.nc * nit, nhb, p.B * p.G)")]},
}
_E = re.escape
PROBES = {
    # the states' fp32 store in the state kernel
    "no_states_store": {"store": [(
        _E("if (pp < P && n < N)\n          *reinterpret_cast<float2*>"),
        "if (pp < 0)\n          *reinterpret_cast<float2*>")]},
    # every output CTA reads head 0's h_prev of chunk 0 (held in the L2)
    "h_shared": {"h": [(
        _E("p.h_split + ((size_t(b) * p.H + h) * p.nc + c) * 2 * P * N;"),
        "p.h_split;")]},
    # every CTA of the state and out kernels reads head 0's x
    "x_shared": {"x": [(
        _E("size_t(b) * p.xb + size_t(t0) * p.xs +\n"
           "                             (g * R + r) * P;"),
        "size_t(b) * p.xb + size_t(t0) * p.xs;", 2)]},
    # no intra-chunk scores or products in the out kernel
    "no_intra": {"intra": [(_E("if (u >= nkt) break;"),
                            "if (u >= 0) break;")]},
}
VARIANTS.update(PROBES)
DEFAULT_RUNS = ["kept", "heads1", "heads2", "heads4", "heads16", "sheads2",
                "sheads4", "sheads8", "tile_fastest", *PROBES, "kept"]


def sources(runs) -> dict:
    """{run: source text} for the named builds (raises if an edit does not
    find its lines)."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    return {r: nv.edit(src, VARIANTS[r], r) for r in dict.fromkeys(runs)}


def main(argv=None) -> int:
    import torch
    runs = list(sys.argv[1:] if argv is None else argv) or DEFAULT_RUNS
    if not torch.cuda.is_available():
        print("ssd_tc: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"nvidia_smi": nv.nvidia_smi(),
                      "torch": torch.__version__}), flush=True)
    libs = nv.build(sources(runs), "ssd_scan")
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    B, S, H, P, G, N, chunk = 1, 3072, 64, 64, 1, 128, 256
    d_in = H * P
    xbc = torch.randn(B, S, d_in + 2 * G * N, generator=gen).to(
        dev, torch.bfloat16)
    x = xbc[..., :d_in].reshape(B, S, H, P)
    Bm = xbc[..., d_in:d_in + G * N].reshape(B, S, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(B, S, G, N)
    dt = torch.exp(torch.empty(B, S, H).uniform_(-6.9, -2.3,
                                                 generator=gen)).to(dev)
    A = -torch.empty(H).uniform_(1.0, 16.0, generator=gen).to(dev)
    h0 = (0.3 * torch.randn(B, H, P, N, generator=gen)).to(dev)
    want = ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)

    def fn():
        return ssd_scan(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)

    bad = []
    for run in runs:
        _build._libs["ssd_scan"] = libs[run]
        got = fn()
        torch.cuda.synchronize()
        r = chip_smoke.ssd_ratios(got, want)
        if run not in PROBES and not max(r.values()) <= 1.0:
            bad.append(run)
        print(json.dumps({"run": run, "ms": chip_smoke.time_ms(fn)[0],
                          "by_kernel_ms": nv.ms_by_kernel(
                              fn, r"ssd_\w+_kernel"),
                          **chip_smoke._cold_times(fn), "ratio": r}),
              flush=True)
    _build._libs.pop("ssd_scan")
    print(json.dumps({"disagree": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
