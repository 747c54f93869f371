#!/usr/bin/env python3
"""The bf16 tensor-core SSD scan (``tools/ssd_scan_tc.cu``) on one card: a
candidate for K5 that the port does not route to (PERF.md §6).

    python3 tools/ssd_tc.py check
    python3 tools/ssd_tc.py time [RUN ...]
    python3 tools/ssd_tc.py chunk [REPS]

``check`` builds the kept source and holds ``ssd_scan_tc`` to the port's
plain version under chip_smoke.py's K5 check (y within 1e-3 / 1e-2 after
the bf16 rounding, h_final within 1e-4 / 1e-4) at chip_smoke.py's bf16 K5
cases, at every (P, N) K5 takes with chunks of 1, 32, 64 and 256 tokens,
and at G = 4 with and without h0, all with x, B and C read in place from a
fused projection; the main case's planted faults must fail that check;
x, B, C or h0 one element off 16 bytes, or a projection row of odd width,
must raise, with the card usable after; the main instances must build
without spills.  Exits nonzero on any miss.

``time`` runs builds of the source with some lines replaced: a VARIANT
(another value of a tuning constant, or another CTA order), or a PROBE,
which leaves part of the work out to show what that part costs (wrong
results, times only).  RUN ``routed`` is the port's K5.  Each run times
the scan at the smoke's main shape (a 3072-token Mamba-2-1.3B chunk: H 64,
P 64, N 128, G 1, chunk 256, the state handed in), device time by kernel
(torch.profiler, as chip_smoke.py times it) and one call between its own
events with a cold and a warm L2, and prints them with its check ratios
as one JSON line.  Runs go in the order given (routed, kept, kept, routed
share one call and one card).  Exits nonzero if a variant disagrees.

``chunk`` times chip_smoke.py's Mamba-2 profile window (the second
3072-token chunk of a 6144-token prompt, the first chunk's state handed
in, at full width with seeded weights) with the routed K5 and with this
scan in turns (routed, tc, tc, routed): REPS calls (default 5) on the
host clock and between CUDA events without the profiler, then the same
under torch.profiler as chip_smoke.py's ``--only profile`` takes it, with
its kernel time by group.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import nvcc_variants as nv  # noqa: E402  (tools/, beside this script)

SOURCE = os.path.join(ROOT, "tools", "ssd_scan_tc.cu")
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
DEFAULT_RUNS = ["routed", "kept", "heads1", "heads2", "heads4", "heads16",
                "sheads2", "sheads4", "sheads8", "tile_fastest", *PROBES,
                "kept", "routed"]

_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 6 \
    + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_libs = {}


def build(names=("kept",)) -> None:
    """Compile the named builds of the source (all at once)."""
    src = open(SOURCE).read()
    _libs.update(nv.build({n: nv.edit(src, VARIANTS[n], n) for n in names
                           if n not in _libs}, "ssd_tc"))


def ssd_scan_tc(x, dt, A, Bm, Cm, *, h0=None, chunk: int = 128,
                build_name: str = "kept"):
    """The candidate in K5's place: ``ssd_scan``'s arguments and results
    (y, h_final), bf16 x/B/C on the card only."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import MAX_CHUNK, SHAPES, _rows
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if not (x.is_cuda and x.dtype == Bm.dtype == Cm.dtype == torch.bfloat16):
        raise TypeError("ssd_scan_tc: bf16 x, B and C on the card")
    if (P, N) not in SHAPES or H % G or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan_tc: shapes {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}")
    chunk = min(chunk, S)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan_tc: chunk {chunk}")
    dev, f32 = x.device, torch.float32
    dt, A = dt.to(f32).contiguous(), A.to(f32).contiguous()
    if h0 is not None:
        h0 = h0.to(f32).contiguous()
    nc = -(-S // chunk)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    h_final = torch.empty((B, H, P, N), dtype=f32, device=dev)
    states = torch.empty((B, H, nc, P, N), dtype=f32, device=dev)
    h_split = torch.empty((B, H, nc, 2, P, N), dtype=torch.bfloat16,
                          device=dev)
    a_cum = torch.empty((B, H, nc * chunk), dtype=f32, device=dev)
    a_tot = torch.empty((B, H, nc), dtype=f32, device=dev)
    if build_name not in _libs:
        build([build_name])
    fn = _libs[build_name].ssd_scan_tc_fwd
    fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), states.data_ptr(),
            h_split.data_ptr(), a_cum.data_ptr(), a_tot.data_ptr(),
            *_rows(x, "x"), *_rows(Bm, "Bm"), *_rows(Cm, "Cm"),
            B, S, H, G, P, N, chunk, nc, _build.stream_ptr(dev))
    _build.check(rc, "ssd_scan_tc")
    return y, h_final


def _case(B, S, H, P, G, N, h0=True, *, seed=0, shift=None, pad=0):
    """bf16 x, B and C as slices of one fused projection (the one named by
    ``shift`` one element later, each row ``pad`` elements wider), dt and
    A in the model's ranges (as chip_smoke.py draws them), and h0 (``h0``
    "shift": one float off 16 bytes)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    d_in, gn = H * P, G * N
    gap = 8 if shift or pad else 0
    starts = {"x": 0, "Bm": d_in + gap, "Cm": d_in + gn + 2 * gap}
    if shift in starts:
        starts[shift] += 1
    xbc = torch.randn(B, S, d_in + 2 * gn + 3 * gap + pad,
                      generator=gen).to(dev, torch.bfloat16)
    x = xbc[..., starts["x"]:starts["x"] + d_in].reshape(B, S, H, P)
    Bm = xbc[..., starts["Bm"]:starts["Bm"] + gn].reshape(B, S, G, N)
    Cm = xbc[..., starts["Cm"]:starts["Cm"] + gn].reshape(B, S, G, N)
    dt = torch.exp(torch.empty(B, S, H).uniform_(-6.9, -2.3,
                                                 generator=gen)).to(dev)
    A = -torch.empty(H).uniform_(1.0, 16.0, generator=gen).to(dev)
    h = (0.3 * torch.randn(B * H * P * N + 1, generator=gen)).to(dev)
    hz = (h[1:] if shift == "h0" else h[:-1]).view(B, H, P, N)
    return x, dt, A, Bm, Cm, hz if h0 else None


def _ratios(got, want):
    import chip_smoke
    return {"y": chip_smoke.close_ratio(got[0], want[0], 1e-3, 1e-2),
            "h": chip_smoke.close_ratio(got[1], want[1], 1e-4, 1e-4)}


def _spills(name: str = "kept") -> dict:
    """ptxas's report of the main-shape (P 64, N 128) tensor-core kernels."""
    import chip_smoke
    rep = chip_smoke._ptxas_report(nv.log_of("ssd_tc", name))
    return {k: v for k, v in rep.items()
            if re.search(r"_tc_kernel(<(\(int\))?64, (\(int\))?128>|"
                         r"ILi64ELi128E)", k)}


def check() -> int:
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    build()
    bad = []

    def hold(name, case, chunk):
        x, dt, A, Bm, Cm, hz = case
        got = ssd_scan_tc(x, dt, A, Bm, Cm, h0=hz, chunk=chunk)
        want = ssd_scan_plain(x, dt, A, Bm, Cm, h0=hz, chunk=chunk)
        torch.cuda.synchronize()
        r = _ratios(got, want)
        if not max(r.values()) <= 1.0:
            bad.append(name)
        print(json.dumps({"case": name, "ratio": r}), flush=True)
        return want

    # chip_smoke.py's bf16 K5 cases
    main = _case(1, 3072, 64, 64, 1, 128)
    py, ph = hold("main", main, 256)
    x, dt, A, Bm, Cm, hz = main
    planted = {"x_one_step_off": (x.roll(1, 1), hz),
               "h0_wrong_head": (x, hz.roll(1, 1))}
    for name, (xp, hp) in planted.items():
        r = _ratios(ssd_scan_tc(xp, dt, A, Bm, Cm, h0=hp, chunk=256),
                    (py, ph))
        if max(r.values()) <= 1.0:
            bad.append(name)
        print(json.dumps({"planted": name, "ratio": r}), flush=True)
    for name, shape, chunk in (
            ("ragged_S", (1, 1000, 64, 64, 1, 128), 256),
            ("S_below_chunk_no_h0", (1, 100, 8, 64, 1, 128, False), 256),
            ("groups4_ragged", (2, 300, 8, 64, 4, 128), 128),
            ("p32_n64", (2, 200, 4, 32, 2, 64), 64),
            ("p16_n32_chunk32", (1, 70, 4, 16, 1, 32), 32),
            ("p16_n16_chunk1", (1, 9, 2, 16, 1, 16), 1),
            ("groups4_h0", (1, 700, 16, 64, 4, 128), 128),
            ("groups4_no_h0", (1, 700, 16, 64, 4, 128, False), 128)):
        hold(name, _case(*shape), chunk)
    for P, N in ((64, 128), (32, 64), (16, 32), (16, 16)):
        for chunk in (1, 32, 64, 256):
            S = 37 if chunk == 1 else 2 * chunk + 29
            hold(f"p{P}_n{N}_chunk{chunk}", _case(2, S, 4, P, 2, N), chunk)
    for which in ("x", "Bm", "Cm", "h0", "row"):
        x, dt, A, Bm, Cm, hz = _case(1, 100, 2, 64, 1, 128,
                                     shift=None if which == "row" else which,
                                     pad=int(which == "row"))
        try:
            ssd_scan_tc(x, dt, A, Bm, Cm, h0=hz, chunk=64)
            torch.cuda.synchronize()
            raised = False
        except RuntimeError:
            raised = True
        if not raised:
            bad.append(f"unaligned_{which}")
        print(json.dumps({"unaligned": which, "raised": raised}), flush=True)
    hold("after_refusals", _case(1, 100, 2, 64, 1, 128), 64)
    spills = _spills()
    if len(spills) != 2 or not all("0 bytes spill stores, 0 bytes spill "
                                   "loads" in v for v in spills.values()):
        bad.append("ptxas")
    print(json.dumps({"ptxas_main": spills}))
    print(json.dumps({"failed": bad}))
    return 1 if bad else 0


def time_runs(runs) -> int:
    import torch
    import chip_smoke
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    build([r for r in dict.fromkeys(runs) if r != "routed"])
    x, dt, A, Bm, Cm, hz = _case(1, 3072, 64, 64, 1, 128)
    want = ssd_scan_plain(x, dt, A, Bm, Cm, h0=hz, chunk=256)
    bad = []
    for run in runs:
        if run == "routed":
            def fn():
                return ssd_scan(x, dt, A, Bm, Cm, h0=hz, chunk=256)
        else:
            def fn(run=run):
                return ssd_scan_tc(x, dt, A, Bm, Cm, h0=hz, chunk=256,
                                   build_name=run)
        got = fn()
        torch.cuda.synchronize()
        r = _ratios(got, want)
        if run not in PROBES and not max(r.values()) <= 1.0:
            bad.append(run)
        print(json.dumps({"run": run, "ms": chip_smoke.time_ms(fn)[0],
                          "by_kernel_ms": nv.ms_by_kernel(
                              fn, r"ssd_\w+_kernel"),
                          **chip_smoke._cold_times(fn), "ratio": r}),
              flush=True)
    print(json.dumps({"disagree": bad}))
    return 1 if bad else 0


def chunk_times(reps: int = 5) -> int:
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cdsp import prefill_chunk_paged
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.serving.cache_manager import PagedKVCache
    build()
    routed = ops.ssd_scan
    ctx = make_context("cuda")
    dev = ctx.device
    cfg = get_config("mamba2-1.3b")
    params = init_params(cfg, seed=0, device=dev)
    none = PagedKVCache(cfg, 1, 64, device=dev).pools        # no attention
    first = torch.randint(0, cfg.vocab_size, (1, 3072), device=dev)
    _, _, aux = prefill_chunk_paged(
        params, cfg, ctx, first,
        torch.arange(3072, dtype=torch.int32, device=dev)[None], none, [], 0)
    toks = torch.randint(0, cfg.vocab_size, (1, 3072), device=dev)
    pos = torch.arange(3072, 6144, dtype=torch.int32, device=dev)[None]

    def window():
        return prefill_chunk_paged(params, cfg, ctx, toks, pos, none, [],
                                   3072, aux)

    for scan in ("routed", "tc", "tc", "routed"):
        ops.ssd_scan = routed if scan == "routed" else ssd_scan_tc
        window()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            window()
        b.record()
        b.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        events = a.elapsed_time(b) / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                window()
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3 / 2
        groups = {k: v / 2 for k, v in chip_smoke._kernel_groups(prof)[0]
                  .items()}
        print(json.dumps({"scan": scan, "reps": reps, "wall_ms": wall,
                          "event_ms": events, "profiled_wall_ms": pwall,
                          "profiled_kernel_ms": groups,
                          "profiled_busy_ms": sum(groups.values())}),
              flush=True)
    ops.ssd_scan = routed
    return 0


def main(argv=None) -> int:
    import torch
    argv = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("ssd_tc: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = argv.pop(0) if argv else "check"
    print(json.dumps({"mode": mode, "nvidia_smi": nv.nvidia_smi(),
                      "torch": torch.__version__}), flush=True)
    if mode == "check":
        return check()
    if mode == "time":
        return time_runs(argv or DEFAULT_RUNS)
    if mode == "chunk":
        return chunk_times(int(argv[0]) if argv else 5)
    print(f"ssd_tc: unknown mode {mode!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
