#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device  — the card, its power limit, the torch/CUDA versions, and the
               build of every kernel from ``src/repro_torch/kernels/csrc``;
  2. kernels — each hand-written kernel against its plain PyTorch version
               on the card, at the main paths' shapes (K1-K4 also at
               Qwen1.5-MoE's, ChatGLM3-6B's and Nemotron-4-15B's heads:
               GQA groups 1, 16 and 6; K1-K3 under Mixtral-8x22B's
               4096-token window; K3/K4 at Whisper-medium's head_dim
               64, non-causal) and at edge cases, with kernel, plain and
               library times (each timed case also one call at a time
               with a cold L2), and K1 over one row of 131,072 keys;
  3. serve   — Llama-3-8B (bf16, 32 layers), Mamba-2-1.3B (bf16, 48
               layers), Qwen1.5-MoE-A2.7B (bf16, 24 layers, 60 routed
               experts top-4), ChatGLM3-6B (bf16, 28 layers, 32 heads over
               2 KV heads) and Nemotron-4-15B (bf16, 32 layers, 48 heads
               over 8), each at full width with seeded weights, serve four
               requests through the port's ServingEngine; each path must
               launch exactly its kernels (K1-K3 for the attention models,
               K5 for Mamba-2), the first chunk, a history chunk and a
               decode tick are held to the plain path on the same weights
               (and, except on Llama, each K1-K3 or K5 call of that replay
               to its plain version on its own inputs), and chunk/tick
               device times plus event-clock TTFT/TBT are printed; on Qwen
               also the share of (token, choice) pairs that capacity
               dropped, and the routing decisions that differ between the
               replays;
  3b. serve_sp — Llama-3-8B at full width, bf16, served by the same
               engine on a 4-position mesh whose positions all sit on the
               one card (``launch.mesh``): both page pools striped 4 ways,
               first chunks through ring attention, second chunks through
               ring-paged prefill over the striped history (K3 per
               position and ring step), ticks through the split-KV paged
               decode (K1 per shard).  Each request's greedy stream
               from the unsharded kernel engine is teacher-forced on the
               unsharded, sharded and plain paths, and at every step each
               path's argmax must be that token or the step a bf16 tie
               (every path scores the two tokens within TIE_TOL), the
               sharded engine's first parting too (exact tokens are held
               in fp32, phase 6); the longest request's replay
               holds each K1/K3 call to its plain version (planted faults
               rejected) and its logits to the plain path's; device ms
               per chunk and tick (sharded and unsharded) and one K3
               call's time at the ring-step shapes are printed;
  4. dense   — Llama-3-8B at full width through CDSP chunked prefill over
               a dense history (K3), the hand-off to dense decode caches,
               and 16 dense decode ticks (K4); the first tick is held to
               the plain path;
  5. whisper — Whisper-medium (bf16, 24 encoder + 24 decoder layers,
               head_dim 64) at full width: four segments' 1500 encoder
               frames and 224-token decoder prompts prefill as one CDSP
               chunk (K3 72 times: encoder, decoder self and cross
               attention), the cross KV is handed to dense decode caches,
               then 32 dense ticks (K4 48 times each: self and cross);
               the prefill and first tick are replayed with each K3/K4
               call held to its plain version, and their logits held to
               the plain path's;
  6. tokens  — fp32 at two layers (full widths): each served model's
               engine gives identical greedy tokens on the kernel path and
               the plain path, Llama's 4-position mesh engine and its
               dense path give the paged engine's tokens, and Whisper's
               path (two encoder and two decoder layers) gives the plain
               path's.

The second-to-last lines are the kernel table (JSON) and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check exits nonzero before that line.  ``--only PHASE ...`` runs a
subset; with no arguments phases 1-6 (3b included) run.  ``--only profile`` adds a
torch.profiler breakdown of one full-width prefill chunk and one decode
tick of each served model and of Whisper (kernel time by group and by
aten op, on Qwen by MoE stage, and the card's idle share); it fails where
a window shows no time for a kernel it must run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12                          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
SOURCES = {
    "paged_flash_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                           "src/repro/kernels/flash_decode.py:598"),
    "paged_flash_prefill": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:275"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:117"),
    "flash_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                     "src/repro/kernels/flash_decode.py:147"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:100"),
}
# the kernels each main path must launch (and no other)
PATHS = {"serve_llama": {"paged_flash_decode", "paged_flash_prefill",
                         "flash_attention"},
         "serve_mamba": {"ssd_scan"},
         "serve_moe": {"paged_flash_decode", "paged_flash_prefill",
                       "flash_attention"},
         "serve_chatglm": {"paged_flash_decode", "paged_flash_prefill",
                           "flash_attention"},
         "serve_nemotron": {"paged_flash_decode", "paged_flash_prefill",
                            "flash_attention"},
         # the mesh path: ring steps and slabs through K3, the split-KV
         # tick through K1; K2 stays on the single-device engine
         "serve_sp": {"paged_flash_decode", "flash_attention"},
         "dense": {"flash_attention", "flash_decode"},
         "whisper": {"flash_attention", "flash_decode"}}
# the served attention models whose replay holds each K1-K3 call to its
# plain version (attn_call_gate)
ATTN_GATED = ("serve_moe", "serve_chatglm", "serve_nemotron")


class CheckFailed(RuntimeError):
    pass


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


# ------------------------------------------------------------------ timing
def _device_ms(prof) -> float:
    """Summed device time (ms) of every kernel and copy a profile saw."""
    total = 0.0
    for ev in prof.key_averages():
        if (ev.device_type.name not in ("CUDA", "PrivateUse1")
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = getattr(ev, "self_device_time_total", None)
        total += (us if us is not None
                  else getattr(ev, "self_cuda_time_total", 0.0))
    return total / 1e3


def time_ms(fn, reps: int = 10, warmup: int = 2, windows: int = 3):
    """(device ms, stream ms) per call: the card's kernel time summed by
    torch.profiler, and CUDA events around ``reps`` back-to-back calls —
    the latter includes the host's launch gaps, which exceed a small
    kernel's own time.  The profiler runs ``windows`` windows of ``reps``
    calls and the median window counts: a window now and then loses some
    or all of its device events and reads far below the others.  Where
    the median window sees no device activity, the event time stands in
    for both."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    stream = start.elapsed_time(end) / reps
    dev = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev.append(_device_ms(prof) / reps)
    return sorted(dev)[windows // 2] or stream, stream


def event_ms(fn, cold: bool, n: int = 20) -> float:
    """Median ms of one call between its own pair of CUDA events.  With
    ``cold``, a 256 MiB scratch tensor is written before each call, so the
    call finds its inputs outside the 50 MB L2, as a decode tick finds a
    layer's K/V (31 other layers' K/V pass through the L2 between two
    reads of it).  The card is held busy while the host enqueues, so each
    pair brackets only the call's kernels (and the gaps between them)."""
    import torch
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        if cold:
            scratch.fill_(1)
        # ~0.5 ms of spinning: longer than the host takes to enqueue a call
        torch.cuda._sleep(1_000_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) for a, b in pairs)
    return ts[len(ts) // 2]


def _cold_times(fn) -> dict:
    """``cold_ms`` (L2 flushed before each call) beside ``warm_event_ms``,
    the same per-call event timing without the flush."""
    return {"cold_ms": event_ms(fn, cold=True),
            "warm_event_ms": event_ms(fn, cold=False)}


def _times(kernel, plain, library, bms, by) -> dict:
    """Kernel, plain and library times; ``library`` None where no single
    PyTorch call computes the function."""
    (k, ks), (p, ps) = time_ms(kernel), time_ms(plain, reps=3)
    lib, ls = time_ms(library) if library is not None else (None, None)
    return dict(ms=k, plain_ms=p, library_ms=lib, bound_ms=bms, bound_by=by,
                stream_ms={"kernel": ks, "plain": ps, "library": ls})


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_b = n_bytes / PEAK_BYTES_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _free() -> None:
    """Return a finished phase's memory to the card: the engine holds
    reference cycles, so its weights outlive ``del`` until a collection."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close_ratio(got, want, atol: float, rtol: float) -> float:
    """Worst elementwise |got - want| / (atol + rtol |want|): the check
    passes at <= 1.  A NaN anywhere gives NaN, which fails it."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


# K1-K4's check against their plain versions, by dtype: o elementwise,
# |o - o_plain| <= atol + rtol |o_plain|.  Both sides do their math in
# fp32 and round o once to its dtype, so they may differ by one ulp of the
# output (2^-7 relative in bf16, under rtol), while an error on the scale
# of |o| itself (~0.02 at the main shapes) fails.  lse is fp32 on both
# sides.
KERNEL_TOL = {"bfloat16": dict(atol=1e-3, rtol=1e-2, lse=1e-4),
              "float32": dict(atol=1e-5, rtol=1e-4, lse=1e-4)}
# K5's check, (atol, rtol): y elementwise in its dtype (bf16 y is rounded
# once on both sides, so they may differ by one ulp of y, under rtol);
# h_final is fp32 on both sides, summed in another order
SSD_TOL = {"bfloat16": (1e-3, 1e-2), "float32": (1e-4, 1e-4),
           "h_final": (1e-4, 1e-4)}
# faults planted in a K5 call's inputs (x, h0): the CDSP hand-off lost, x
# one token late, the state of the wrong head
SSD_FAULTS = {"h0_dropped": lambda x, h0: (x, None),
              "x_one_step_off": lambda x, h0: (x.roll(1, 1), h0),
              "h0_wrong_head": lambda x, h0: (x, h0.roll(1, 1))}


def ssd_ratios(got, want) -> dict:
    """K5's check of ``got`` = (y, h_final) against the plain scan's
    ``want``: {"y": ratio, "h": ratio}, each passing at <= 1."""
    ya, yr = SSD_TOL[str(want[0].dtype).split(".")[-1]]
    return {"y": close_ratio(got[0], want[0], ya, yr),
            "h": close_ratio(got[1], want[1], *SSD_TOL["h_final"])}


def ssd_planted(x, dt, A, Bm, Cm, h0, chunk) -> dict:
    """{fault: the worse of K5's two ratios} for the plain scan of these
    inputs with each of ``SSD_FAULTS`` planted, against the plain scan of
    the inputs as they are: a check that can see the fault reads > 1."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    want = ssd_scan_plain(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
    out = {}
    for name, fault in SSD_FAULTS.items():
        xf, hf = fault(x, h0)
        out[name] = max(ssd_ratios(ssd_scan_plain(
            xf, dt, A, Bm, Cm, h0=hf, chunk=chunk), want).values())
    return out


# ---------------------------------------------------------------- phase 1
def _ptxas_report(log: str) -> dict:
    """{kernel: "spills; registers"} from an ``nvcc -Xptxas -v`` log, the
    kernels' names put through ``cu++filt`` where the toolkit has it."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = ""
        elif name and ("spill" in ln or "registers" in ln):
            out[name] = (out[name] + "; " if out[name] else "") + \
                ln.split(":")[-1].strip()
    from repro_torch.kernels import _build
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    if out and os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(out), text=True,
                               capture_output=True, timeout=60
                               ).stdout.splitlines()
        if len(names) == len(out):
            out = dict(zip(names, out.values()))
    return out


# K5's bf16 instances at the main path's head shape (P 64, N 128), whose
# report phase_device holds to no spills
_SSD_MAIN_TC = re.compile(r"ssd_(state|out)_tc_kernel(<(\(int\))?64, "
                          r"(\(int\))?128>|ILi64ELi128E)")


def phase_device():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    per = _build.build()
    wall = time.perf_counter() - t0
    ptxas = {}
    for name in _build.SOURCES:
        log = (_build.BUILD / f"{name}.log")
        if log.exists():
            ptxas[name] = _ptxas_report(log.read_text())
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=round(wall, 2),
         build_s_per_source={k: round(v, 2) for k, v in per.items()})
    emit(phase="device", ptxas=ptxas)
    main_tc = {k: v for k, v in ptxas.get("ssd_scan", {}).items()
               if _SSD_MAIN_TC.search(k)}
    check(len(main_tc) == 2 and all(
        "0 bytes spill stores, 0 bytes spill loads" in v
        for v in main_tc.values()),
        f"K5's main tensor-core instances spill or are missing: {main_tc}")
    return smi


# ---------------------------------------------------------------- phase 2
def _pool_from_dense(k, page, gen):
    """Scatter dense per-row KV (B, S, KVH, D) into a shuffled page pool.
    Returns pool (n_pages + 1, page, KVH, D) — the last page is scratch,
    filled with NaN so a masked read that leaks shows up — and the table."""
    import torch
    B, S, KVH, D = k.shape
    npg = -(-S // page)
    n_pages = B * npg + 3          # spare pages the tables never name
    order = torch.randperm(n_pages, generator=gen, device="cpu")
    pool = torch.full((n_pages + 1, page, KVH, D), float("nan"),
                      dtype=k.dtype, device=k.device)
    table = order[:B * npg].reshape(B, npg).to(torch.int32)
    pad = torch.zeros((B, npg * page - S, KVH, D), dtype=k.dtype,
                      device=k.device)
    full = torch.cat([k, pad], 1).reshape(B, npg, page, KVH, D)
    pool[table.long().to(k.device)] = full
    return pool, table.to(k.device)


def _sdpa(q, k, v, mask, causal=True):
    """One library call over the same K/V: q (B, Sq, H, D), k/v
    (B, Sk, KVH, D), mask (B, Sq, Sk) bool, or None for plain causal (no
    mask at all with ``causal`` False)."""
    import torch
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    if mask is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m)


def phase_kernels(full_shapes: bool = True):
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, paged_flash_prefill,
        paged_flash_prefill_plain)
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_decode import (
        POS_PAD, flash_decode, flash_decode_plain, paged_flash_decode,
        paged_flash_decode_plain)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    tol = {getattr(torch, k): v for k, v in KERNEL_TOL.items()}
    rows = {}
    failures = []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def o_errs(o, po, dtype):
        t = tol[dtype]
        return {"o": max_err(o, po),
                "o_ratio": close_ratio(o, po, t["atol"], t["rtol"])}

    def dead_rows(o, lse, plain_lse):
        """Rows with no valid key (the plain lse at NEG_INF) must read
        o = 0 and lse = -1e30 exactly: {"dead_rows_off": count}."""
        dead = plain_lse <= -1e29                       # (B, H, Sq)
        if not bool(dead.any()):
            return {}
        od = o.transpose(1, 2)[dead]                    # (n, D)
        off = int((od != 0).any(-1).sum()) + int((lse[dead] != -1e30).sum())
        return {"dead_rows_off": float(off)}

    def record(name, case, dtype, errs, main=False, times=None,
               planted=None, tol_used=None):
        """``errs`` holds max abs errors and ``*_ratio`` entries (error
        over its allowance, <= 1 passes).  ``planted``: {fault: ratio} of
        plain results with a fault planted (V one key off, ...), which the
        same check must reject (ratio > 1) to show it can see that fault
        at these shapes."""
        t = tol[dtype]
        ok = (all(v <= 1.0 for k, v in errs.items() if k.endswith("_ratio"))
              and errs.get("lse", 0.0) <= t["lse"]
              and errs.get("pool", 0.0) == 0.0
              and errs.get("dead_rows_off", 0.0) == 0.0)
        extra = {}
        if planted is not None:
            extra["planted"] = {k: {"ratio": v, "rejected": v > 1.0}
                                for k, v in planted.items()}
            ok = ok and all(v > 1.0 for v in planted.values())
        emit(phase="kernels", kernel=name, case=case,
             dtype=str(dtype).split(".")[-1], max_abs_err=errs,
             tol=tol_used or {"o_atol": t["atol"], "o_rtol": t["rtol"],
                              "lse": t["lse"], "pool": 0.0},
             ok=ok, **extra, **(times or {}))
        if not ok:
            failures.append(f"{name}/{case}")
        if main:
            rows[name] = dict(max_abs_err=max(
                v for k, v in errs.items()
                if not k.endswith("_ratio")
                and k not in ("pool", "dead_rows_off")), **times)

    # ---- K3: flash attention over a chunk's own KV
    def k3(case, B, Sq, Sk, H, KVH, D, dtype, causal=True, window=None,
           offset=0, perm=None, main=False, timed=False):
        """``perm``: "within" shuffles key positions inside each 64-key
        tile, "across" over all keys (K/V rows move with them), so a tile's
        positions are neither sorted nor its index's.  ``main``: the kernel
        table's row; ``timed`` (implied by ``main``): times and a planted
        fault."""
        timed = timed or main
        q = randn(B, Sq, H, D, dtype=dtype)
        k = randn(B, Sk, KVH, D, dtype=dtype)
        v = randn(B, Sk, KVH, D, dtype=dtype)
        qp = torch.arange(offset, offset + Sq, dtype=torch.int32, device=dev)
        kp = torch.arange(Sk, dtype=torch.int32, device=dev)
        if perm is not None:
            if perm == "within":
                idx = torch.cat([t0 + torch.randperm(min(64, Sk - t0),
                                                     generator=gen)
                                 for t0 in range(0, Sk, 64)])
            else:
                idx = torch.randperm(Sk, generator=gen)
            idx = idx.to(dev)
            kp, k, v = kp[idx], k[:, idx], v[:, idx]
        o, l = flash_attention(q, k, v, qp, kp, causal=causal, window=window)
        po, pl = flash_attention_plain(q, k, v, qp, kp, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        errs = {**o_errs(o, po, dtype), "lse": max_err(l, pl),
                **dead_rows(o, l, pl)}
        times = planted = None
        if timed:
            bad, _ = flash_attention_plain(q, k, v.roll(1, 1), qp, kp,
                                           causal=causal, window=window)
            t = tol[dtype]
            planted = {"v_one_key_off": close_ratio(bad, po, t["atol"],
                                                    t["rtol"])}
            pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
            es = torch.finfo(dtype).bits // 8
            nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KVH * D) * es \
                + B * H * Sq * 4 + (Sq + Sk) * 4
            bms, by = bound_ms(nbytes, 4 * B * H * D * pairs,
                               str(dtype).split(".")[-1])
            kw = dict(causal=causal, window=window)
            times = _times(
                lambda: flash_attention(q, k, v, qp, kp, **kw),
                lambda: flash_attention_plain(q, k, v, qp, kp, **kw),
                _sdpa(q, k, v, None, causal), bms, by)
            times.update(_cold_times(
                lambda: flash_attention(q, k, v, qp, kp, **kw)))
        record("flash_attention", case, dtype, errs, main, times, planted)

    # ---- K2: chunk queries against history pages
    def nan_tails(pools, table, lengths, page):
        """NaN in each row's slots at and past its length within its
        table's pages (inside the last page's key tile), where
        ``_pool_from_dense`` leaves zeros."""
        f = torch.arange(table.shape[1] * page, device=dev)
        r, f = torch.nonzero(f[None] >= lengths[:, None], as_tuple=True)
        for pool in pools:
            pool[table[r, f // page].long(), f % page] = float("nan")

    def k2(case, B, Sq, hist, H, KVH, D, page, dtype, window=None,
           main=False, fault=False, timed=False, nan_tail=False):
        """``fault`` (implied by ``main`` and ``timed``): the check must
        also reject a planted fault (V one key off) at this case's shape;
        ``timed`` (implied by ``main``): times; ``nan_tail``: NaN in the
        slots past each row's history."""
        timed = timed or main
        q = randn(B, Sq, H, D, dtype=dtype)
        S_h = max(hist) if max(hist) > 0 else page
        kd = randn(B, S_h, KVH, D, dtype=dtype)
        vd = randn(B, S_h, KVH, D, dtype=dtype)
        g2 = torch.Generator(device="cpu").manual_seed(1)
        kpool, table = _pool_from_dense(kd, page, g2)
        g2.manual_seed(1)
        vpool, _ = _pool_from_dense(vd, page, g2)
        hl = torch.tensor(hist, dtype=torch.int32, device=dev)
        if nan_tail:
            nan_tails((kpool, vpool), table, hl, page)
        qp = (hl[:, None] + torch.arange(Sq, dtype=torch.int32,
                                         device=dev)[None])
        o, l = paged_flash_prefill(q, kpool, vpool, table, hl, qp,
                                   window=window)
        po, pl = paged_flash_prefill_plain(q, kpool, vpool, table, hl, qp,
                                           window=window)
        torch.cuda.synchronize()
        errs = {**o_errs(o, po, dtype), "lse": max_err(l, pl),
                **dead_rows(o, l, pl)}
        times = planted = None
        if timed or fault:
            g2.manual_seed(1)
            vbad, _ = _pool_from_dense(vd.roll(1, 1), page, g2)
            bad, _ = paged_flash_prefill_plain(q, kpool, vbad, table, hl, qp,
                                               window=window)
            t = tol[dtype]
            planted = {"v_one_key_off": close_ratio(bad, po, t["atol"],
                                                    t["rtol"])}
            del vbad
        if timed:
            es = torch.finfo(dtype).bits // 8
            nbytes = 2 * B * Sq * H * D * es + 2 * sum(hist) * KVH * D * es \
                + B * H * Sq * 4
            bms, by = bound_ms(nbytes, 4 * H * D * Sq * sum(hist),
                               str(dtype).split(".")[-1])
            kg = kd[:, :max(hist)]
            vg = vd[:, :max(hist)]
            mask = (torch.arange(max(hist), device=dev)[None, None]
                    < hl[:, None, None]).expand(B, Sq, max(hist))
            times = _times(
                lambda: paged_flash_prefill(q, kpool, vpool, table, hl, qp),
                lambda: paged_flash_prefill_plain(q, kpool, vpool, table, hl,
                                                  qp),
                _sdpa(q, kg, vg, mask), bms, by)
            times.update(_cold_times(
                lambda: paged_flash_prefill(q, kpool, vpool, table, hl, qp)))
        record("paged_flash_prefill", case, dtype, errs, main, times,
               planted)

    # ---- K1: paged decode with the fused append
    def k1(case, lengths, H, KVH, D, page, dtype, window=None, append=True,
           pos_pad_cols=0, pad_rows=(), main=False, timed=False,
           nan_tail=False):
        """``main``: the kernel table's row; ``timed`` (implied by
        ``main``): times (warm and cold L2) and a planted fault;
        ``nan_tail``: NaN in the slots at and past each row's length (the
        append slot included, which the call writes first)."""
        timed = timed or main
        B = len(lengths)
        S = max(max(lengths) + 1, 1)
        q = randn(B, H, D, dtype=dtype)
        kd = randn(B, S, KVH, D, dtype=dtype)
        vd = randn(B, S, KVH, D, dtype=dtype)
        g2 = torch.Generator(device="cpu").manual_seed(2)
        kpool, table = _pool_from_dense(kd, page, g2)
        g2.manual_seed(2)
        vpool, _ = _pool_from_dense(vd, page, g2)
        npg = table.shape[1]
        scratch = kpool.shape[0] - 1
        for r in pad_rows:
            # an idle batch row, as the engine pads it: every column on
            # the scratch page (which all such rows append into at once)
            table[r] = scratch
        live_rows = [r for r in range(B) if r not in pad_rows]
        page_pos = None
        if pos_pad_cols:
            table = torch.cat([table, torch.full((B, pos_pad_cols), scratch,
                                                 dtype=torch.int32,
                                                 device=dev)], 1)
            page_pos = torch.cat(
                [(torch.arange(npg, dtype=torch.int32, device=dev)
                  * page)[None].expand(B, npg),
                 torch.full((B, pos_pad_cols), POS_PAD, dtype=torch.int32,
                            device=dev)], 1)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if nan_tail:
            nan_tails((kpool, vpool), table[:, :npg], ln, page)
        kw = dict(window=window, page_pos=page_pos)
        if append:
            rows_ = torch.arange(B, device=dev)
            kw.update(k_new=randn(B, KVH, D, dtype=dtype),
                      v_new=randn(B, KVH, D, dtype=dtype),
                      append_page=table[rows_, (ln // page).long()],
                      append_slot=ln % page)
        kp2, vp2 = kpool.clone(), vpool.clone()
        planted = None
        if timed:
            g2.manual_seed(2)
            vbad, _ = _pool_from_dense(vd.roll(1, 1), page, g2)
            bad, _ = paged_flash_decode_plain(q, kpool.clone(), vbad, table,
                                              ln, **kw)
            del vbad
        o, l = paged_flash_decode(q, kpool, vpool, table, ln, **kw)
        po, pl = paged_flash_decode_plain(q, kp2, vp2, table, ln, **kw)
        torch.cuda.synchronize()
        live = slice(0, scratch)            # scratch bytes are garbage
        o, po, l, pl = o[live_rows], po[live_rows], l[live_rows], pl[live_rows]
        if timed:
            t = tol[dtype]
            planted = {"v_one_key_off": close_ratio(
                bad[live_rows], po, t["atol"], t["rtol"])}
        errs = {**o_errs(o, po, dtype), "lse": max_err(l, pl),
                "pool": float(not (torch.equal(kpool[live].nan_to_num(7.0),
                                               kp2[live].nan_to_num(7.0))
                                   and torch.equal(
                                       vpool[live].nan_to_num(7.0),
                                       vp2[live].nan_to_num(7.0))))}
        times = None
        if timed:
            es = torch.finfo(dtype).bits // 8
            att = sum(lengths) + (B if append else 0)
            nbytes = 2 * B * H * D * es + 2 * att * KVH * D * es \
                + B * H * 4 + (2 * B * KVH * D * es if append else 0)
            bms, by = bound_ms(nbytes, 4 * H * D * att,
                               str(dtype).split(".")[-1])
            Smax = max(lengths) + 1
            kg = kd[:, :Smax]
            vg = vd[:, :Smax]
            mask = (torch.arange(Smax, device=dev)[None, None]
                    < (ln + 1)[:, None, None])
            times = _times(
                lambda: paged_flash_decode(q, kpool, vpool, table, ln, **kw),
                lambda: paged_flash_decode_plain(q, kp2, vp2, table, ln,
                                                 **kw),
                _sdpa(q[:, None], kg, vg, mask), bms, by)
            times.update(_cold_times(
                lambda: paged_flash_decode(q, kpool, vpool, table, ln, **kw)))
        record("paged_flash_decode", case, dtype, errs, main, times,
               planted)

    # ---- K4: one query per row over a dense cache
    def k4(case, lengths, S, H, KVH, D, dtype, window=None, kv_offset=0,
           main=False, timed=False):
        """``main``: the kernel table's row; ``timed`` (implied by
        ``main``): times (warm and cold L2) and a planted fault."""
        timed = timed or main
        B = len(lengths)
        q = randn(B, H, D, dtype=dtype)
        k = randn(B, S, KVH, D, dtype=dtype)
        v = randn(B, S, KVH, D, dtype=dtype)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(window=window, kv_offset=kv_offset)
        o, l = flash_decode(q, k, v, ln, **kw)
        po, pl = flash_decode_plain(q, k, v, ln, **kw)
        torch.cuda.synchronize()
        errs = {**o_errs(o, po, dtype), "lse": max_err(l, pl)}
        times = planted = None
        if timed:
            t = tol[dtype]
            bad, _ = flash_decode_plain(q, k, v.roll(1, 1), ln, **kw)
            planted = {"v_one_key_off": close_ratio(bad, po, t["atol"],
                                                    t["rtol"])}
            es = torch.finfo(dtype).bits // 8
            att = sum(lengths)
            nbytes = 2 * B * H * D * es + 2 * att * KVH * D * es \
                + B * H * 4 + B * 4
            bms, by = bound_ms(nbytes, 4 * H * D * att,
                               str(dtype).split(".")[-1])
            mask = (torch.arange(S, device=dev)[None, None]
                    < ln[:, None, None])
            times = _times(lambda: flash_decode(q, k, v, ln, **kw),
                           lambda: flash_decode_plain(q, k, v, ln, **kw),
                           _sdpa(q[:, None], k, v, mask), bms, by)
            times.update(_cold_times(lambda: flash_decode(q, k, v, ln,
                                                          **kw)))
        record("flash_decode", case, dtype, errs, main, times, planted)

    # ---- K5: the Mamba-2 chunked SSD scan, under SSD_TOL
    def k5(case, B, S, H, P, G, N, chunk, dtype, h0=True, via_ops=False,
           main=False):
        d_in = H * P
        # x, B and C as the model hands them over: slices of one fused
        # projection, strided by its row
        xbc = randn(B, S, d_in + 2 * G * N, dtype=dtype)
        x = xbc[..., :d_in].reshape(B, S, H, P)
        Bm = xbc[..., d_in:d_in + G * N].reshape(B, S, G, N)
        Cm = xbc[..., d_in + G * N:].reshape(B, S, G, N)
        # step sizes and decay rates in the model's ranges
        dt = torch.exp(torch.empty(B, S, H).uniform_(
            -6.9, -2.3, generator=gen)).to(dev)
        A = -torch.empty(H).uniform_(1.0, 16.0, generator=gen).to(dev)
        hz = (0.3 * torch.randn(B, H, P, N, generator=gen)).to(dev) \
            if h0 else None
        if via_ops:
            y, h = ops.ssd(x, dt, A, Bm, Cm, h0=hz, chunk=chunk)
            py, ph = ops.ssd(x, dt, A, Bm, Cm, h0=hz, chunk=chunk,
                             impl="ref")
        else:
            y, h = ssd_scan(x, dt, A, Bm, Cm, h0=hz, chunk=chunk)
            py, ph = ssd_scan_plain(x, dt, A, Bm, Cm, h0=hz, chunk=chunk)
        torch.cuda.synchronize()
        r = ssd_ratios((y, h), (py, ph))
        errs = {"o": max_err(y, py), "o_ratio": r["y"],
                "h": max_err(h, ph), "h_ratio": r["h"]}
        times = planted = None
        if main:
            planted = ssd_planted(x, dt, A, Bm, Cm, hz, chunk)
            es = torch.finfo(dtype).bits // 8
            # every input read once, every output written once
            nbytes = (2 * B * S * H * P + 2 * B * S * G * N) * es \
                + B * S * H * 4 + H * 4 + 2 * B * H * P * N * 4
            # what the causal chunks need: C.B^T once per group, the
            # masked product with x, the chunk states and the inter-chunk
            # output per head
            flops = 0
            for c0 in range(0, S, chunk):
                lc = min(chunk, S - c0)
                tri = lc * (lc + 1) // 2
                flops += B * (2 * tri * N * G + 2 * tri * P * H
                              + 4 * lc * P * N * H)
            bms, by = bound_ms(nbytes, flops, str(dtype).split(".")[-1])
            times = _times(
                lambda: ssd_scan(x, dt, A, Bm, Cm, h0=hz, chunk=chunk),
                lambda: ssd_scan_plain(x, dt, A, Bm, Cm, h0=hz,
                                       chunk=chunk),
                None, bms, by)
            times.update(_cold_times(
                lambda: ssd_scan(x, dt, A, Bm, Cm, h0=hz, chunk=chunk)))
        ya, yr = SSD_TOL[str(dtype).split(".")[-1]]
        ha, hr = SSD_TOL["h_final"]
        record("ssd_scan", case, dtype, errs, main, times, planted,
               tol_used={"y_atol": ya, "y_rtol": yr, "h_atol": ha,
                         "h_rtol": hr})

    bf, f32 = torch.bfloat16, torch.float32
    # main path shapes: Llama-3-8B (H 32, KVH 8, D 128), page 64; the smoke
    # trace's longest prompt (6144) runs as two 3072-token chunks, and the
    # decode batch is its four requests
    if full_shapes:
        k3("main", 1, 3072, 3072, 32, 8, 128, bf, main=True)
        k2("main", 1, 3072, [3072], 32, 8, 128, 64, bf, main=True)
        # the last page's NaN slots inside a 64-key tile
        k2("main_hist3000", 1, 3072, [3000], 32, 8, 128, 64, bf, fault=True)
        k1("main", [512, 2048, 4096, 6144], 32, 8, 128, 64, bf, main=True)
        # one row at Llama 3.1 8B's published context (131,072 keys) plus
        # the fused append: 537 MB of K/V, ten times the L2
        k1("long_131072", [131072], 32, 8, 128, 64, bf, timed=True)
        # Qwen1.5-MoE-A2.7B's heads (H 16, KVH 16, D 128: one head a GQA
        # group, so a 128-row tile of K2/K3 holds 128 queries of one head)
        # at the same chunks, history and decode batch
        k3("qwen_main", 1, 3072, 3072, 16, 16, 128, bf, timed=True)
        k2("qwen_main", 1, 3072, [3072], 16, 16, 128, 64, bf, timed=True)
        k2("qwen_hist3000", 1, 3072, [3000], 16, 16, 128, 64, bf,
           fault=True)
        k1("qwen_main", [512, 2048, 4096, 6144], 16, 16, 128, 64, bf,
           timed=True)
        # the dense path's decode batch: the smoke prompts in a dense cache
        k4("main", [512, 2048, 4096, 6144], 6144, 32, 8, 128, bf,
           main=True)
        # ChatGLM3-6B's heads (H 32 over KVH 2, D 128: a GQA group of 16,
        # so a 128-row tile of K2/K3 holds 8 queries) and Nemotron-4-15B's
        # (H 48 over KVH 8: a group of 6, 21 queries and 126 live rows a
        # tile) at the same chunks, history and decode batch; K4 at both
        # groups over the dense path's batch
        for who, H, KVH in (("chatglm", 32, 2), ("nemotron", 48, 8)):
            k3(f"{who}_main", 1, 3072, 3072, H, KVH, 128, bf, timed=True)
            k2(f"{who}_main", 1, 3072, [3072], H, KVH, 128, 64, bf,
               timed=True)
            k2(f"{who}_hist3000", 1, 3072, [3000], H, KVH, 128, 64, bf,
               fault=True)
            k1(f"{who}_main", [512, 2048, 4096, 6144], H, KVH, 128, 64, bf,
               timed=True)
            k4(f"{who}_main", [512, 2048, 4096, 6144], 6144, H, KVH, 128,
               bf, timed=True)
        # Mixtral-8x22B's heads (H 48, KVH 8) under its 4096-token window,
        # over rows longer than the window: K3 a second 3072-token chunk
        # over the first's keys, K2 1024 queries after 5000 history tokens,
        # K1 a batch with rows on both sides of 4096
        k3("mixtral_window4096", 1, 3072, 6144, 48, 8, 128, bf,
           window=4096, offset=3072)
        k2("mixtral_window4096", 1, 1024, [5000], 48, 8, 128, 64, bf,
           window=4096, fault=True)
        k1("mixtral_window4096", [4500, 6144, 100, 8000], 48, 8, 128, 64,
           bf, window=4096)
        # Mamba-2-1.3B: a 3072-token CDSP chunk with the state handed in
        # Whisper-medium (H 16 = KVH 16, D 64, non-causal): K3 over the
        # encoder's 1500 frames for four segments and the decoder's 224
        # prompt tokens over them (cross attention); K4 the cross-decode
        # tick, four rows of 1500 keys
        k3("whisper_encoder", 4, 1500, 1500, 16, 16, 64, bf, causal=False,
           timed=True)
        k3("whisper_cross", 4, 224, 1500, 16, 16, 64, bf, causal=False,
           timed=True)
        k4("whisper_cross_decode", [1500] * 4, 1500, 16, 16, 64, bf,
           timed=True)
        # K1 and K2 at Whisper's heads (no path of the smoke runs them at
        # head_dim 64): the smoke's decode batch in 64-token pages, and a
        # 3072-token chunk over 3072 history tokens
        k1("d64_whisper_heads", [512, 2048, 4096, 6144], 16, 16, 64, 64, bf,
           timed=True)
        k2("d64_whisper_heads", 1, 3072, [3072], 16, 16, 64, 64, bf,
           timed=True)
        k5("main", 1, 3072, 64, 64, 1, 128, 256, bf, main=True)
        k5("ragged_S_via_ops", 1, 1000, 64, 64, 1, 128, 256, bf,
           via_ops=True)
        k5("main_fp32", 1, 1024, 64, 64, 1, 128, 256, f32)
        k3("main_fp32", 1, 1024, 1024, 32, 8, 128, f32)
        k2("main_fp32", 1, 512, [1536], 32, 8, 128, 64, f32)
        k1("main_fp32", [100, 700, 1500, 3000], 32, 8, 128, 64, f32)
    for dt in (bf, f32):
        # ragged Sq and Sk, non-causal, head_dim 32, GQA groups 1/2/4
        k3("ragged_noncausal_d32_g2", 2, 100, 77, 4, 2, 32, dt, causal=False)
        k3("ragged_causal_offset_g4", 1, 70, 130, 8, 2, 128, dt, offset=60)
        k3("window_g1", 1, 129, 129, 4, 4, 32, dt, window=17)
        k3("causal_all_masked_rows", 1, 40, 40, 4, 2, 32, dt, offset=-20)
        # tiles classified by their positions, not their indices
        k3("perm_within_tiles", 1, 300, 300, 8, 2, 128, dt, perm="within")
        k3("perm_across_tiles_window", 1, 200, 333, 8, 2, 32, dt,
           offset=133, window=90, perm="across")
        # fewer queries than one 128-row tile
        k3("sq17_d128_g4", 1, 17, 17, 8, 2, 128, dt)
        k3("sq17_d32_g2", 2, 17, 150, 4, 2, 32, dt, offset=133)
        k2("sq17_d128_g4", 1, 17, [3000], 32, 8, 128, 64, dt)
        k2("sq17_d32_g1_page16", 2, 17, [70, 129], 4, 4, 32, 16, dt)
        k2("page8_d32_g2_ragged", 2, 37, [45, 3], 4, 2, 32, 8, dt)
        k2("page16_window_g4", 1, 50, [200], 8, 2, 128, 16, dt, window=70)
        k2("page32_masked_rows", 2, 33, [96, 0], 4, 4, 32, 32, dt)
        k1("page8_d32_g1_padded_rows", [13, 0, 0, 5], 4, 4, 32, 8, dt,
           pad_rows=(1, 2))
        k1("page16_g2_window_pospad", [100, 31], 4, 2, 32, 16, dt,
           window=24, pos_pad_cols=3)
        k1("page32_g4_no_append", [64, 0, 1], 8, 2, 128, 32, dt,
           append=False)
        k1("page64_g8_window", [300, 7], 16, 2, 128, 64, dt, window=100)
        k4("ragged_S_g4_zero_row", [77, 0, 30], 77, 8, 2, 128, dt)
        k4("window_offset_d32_g1", [300, 129], 300, 4, 4, 32, dt,
           window=50, kv_offset=20)
        k4("g8_short", [1, 5], 8, 16, 2, 128, dt)
        # GQA groups 6 and 16: head_dim 32, padded rows, windows, POS_PAD
        # columns, ragged S and chunks, masked rows, pages 8-64
        k1("page16_g6_d32_padded_window", [300, 0, 45], 12, 2, 32, 16, dt,
           window=100, pad_rows=(1,))
        k1("page8_g16_d32_pospad", [200, 17], 16, 1, 32, 8, dt,
           pos_pad_cols=2)
        k1("page64_g16_d128", [700, 3], 32, 2, 128, 64, dt)
        k1("page32_g6_d128_window", [500, 64], 48, 8, 128, 32, dt,
           window=70)
        k4("g6_d32_window_offset_zero_row", [300, 129, 0], 300, 12, 2, 32,
           dt, window=50, kv_offset=20)
        k4("g16_ragged_S", [77, 0, 30], 77, 16, 1, 128, dt)
        k3("g6_d32_ragged_window", 2, 100, 150, 12, 2, 32, dt, offset=50,
           window=40)
        k3("g16_d128_sq17_masked_rows", 1, 17, 30, 32, 2, 128, dt,
           offset=-5)
        k3("g6_d128_perm_across", 1, 200, 200, 48, 8, 128, dt,
           perm="across")
        k2("g6_d32_page16_ragged", 2, 37, [45, 3], 12, 2, 32, 16, dt)
        k2("g16_d128_page8_masked_rows", 2, 33, [96, 0], 32, 2, 128, 8, dt)
        # head_dim 64 (Whisper): ragged and non-causal K3, NaN in unused
        # pool slots for K1/K2 (K2's pages 16 and 64 by TMA, 48 by
        # cp.async), K4 over a ragged S
        k3("d64_noncausal_ragged_g1", 2, 150, 333, 4, 4, 64, dt,
           causal=False)
        k3("d64_causal_offset_g4", 1, 70, 130, 8, 2, 64, dt, offset=60)
        k3("d64_sq17_masked_rows_g2", 1, 17, 30, 4, 2, 64, dt, offset=-5)
        k2("d64_page16_nan_tail_g1", 2, 37, [45, 3], 4, 4, 64, 16, dt,
           nan_tail=True)
        k2("d64_page64_nan_tail_g4", 1, 50, [200], 8, 2, 64, 64, dt,
           nan_tail=True)
        k2("d64_page48_window_g1", 1, 33, [150], 4, 4, 64, 48, dt,
           window=70, nan_tail=True)
        k1("d64_page16_g1_nan_tail_padded", [300, 0, 45], 4, 4, 64, 16, dt,
           pad_rows=(1,), nan_tail=True)
        k1("d64_page64_g16_window", [700, 3], 32, 2, 64, 64, dt, window=100,
           nan_tail=True)
        k4("d64_ragged_S_g1_zero_row", [77, 0, 30], 77, 4, 4, 64, dt)
        k4("d64_window_offset_g6", [300, 129], 300, 12, 2, 64, dt,
           window=50, kv_offset=20)
        k5("S_below_chunk_no_h0", 1, 100, 8, 64, 1, 128, 256, dt,
           h0=False)
        k5("groups4_ragged", 2, 300, 8, 64, 4, 128, 128, dt, via_ops=True)
        k5("p32_n64", 2, 200, 4, 32, 2, 64, 64, dt)
        k5("p16_n32_chunk32", 1, 70, 4, 16, 1, 32, 32, dt)
        k5("p16_n16_chunk1", 1, 9, 2, 16, 1, 16, 1, dt)
    emit(phase="kernels", failures=failures)
    check(not failures, f"kernels disagree with their plain versions: "
          f"{failures}")
    return rows


# ---------------------------------------------------------------- phase 3
def _two_chunk_policy():
    from repro_torch.core.chunk_planner import Allocation, Chunk
    from repro_torch.core.latency_model import table1_model
    from repro_torch.launch.serve import SPEC
    from repro_torch.serving.simulator import Policy

    class TwoChunkPolicy(Policy):
        """Every prompt of two or more tokens runs as two chunks, the
        second over the first's paged history at SP 2.  The tetris plan
        keeps each smoke prompt to one chunk (the cluster is idle), which
        would leave the history kernel unexercised."""
        name = "two_chunk"

        def plan(self, req, pool, now):
            L = req.prompt_len
            l0 = L // 2
            t_q = pool[0]
            t0 = t_q + self.model.latency(1, 0, l0)
            t1 = max(t0, pool[1]) + self.model.latency(2, l0, L - l0)
            return Allocation([Chunk(l0, (0,), t_q, t0),
                               Chunk(L - l0, (0, 1), t0, t1)])

    return TwoChunkPolicy(table1_model(), SPEC)


def _counters():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     paged_flash_prefill)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  paged_flash_decode)
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"paged_flash_decode": paged_flash_decode,
            "paged_flash_prefill": paged_flash_prefill,
            "flash_attention": flash_attention,
            "flash_decode": flash_decode,
            "ssd_scan": ssd_scan}


def _reset_counts():
    for f in _counters().values():
        f.launches = 0


def _read_counts():
    return {k: f.launches for k, f in _counters().items()}


def _check_launches(counts: dict, path: str) -> None:
    """A main path launched every kernel it runs, and no other."""
    want = PATHS[path]
    check(all(counts[k] > 0 for k in want),
          f"{path}: a kernel of the path was not launched: {counts}")
    check(not any(c for k, c in counts.items() if k not in want),
          f"{path}: a kernel outside the path was launched: {counts}")


def _serve(cfg, params, prompts, ctx, output_len, **kw):
    from repro_torch.launch.serve import serve
    return serve(cfg, params, prompts, ctx=ctx, policy=_two_chunk_policy(),
                 output_len=output_len, rate=2.0, max_batch=4, **kw)


def _hist(eng, name):
    h = eng.metrics.snapshot()["histograms"].get(name)
    return None if h is None else {k: v for k, v in h.items()
                                   if k != "buckets"}


def _replay(cfg, params, ctx, prompt, tokens):
    """Request ``prompt`` through the engine's own functions on a fresh
    pool: chunk 1, chunk 2 over its history (attention: the pages, K2 +
    K3, or on a mesh context the striped pages through the ring; Mamba-2:
    the handed-over SSD state and conv window, K5), then one decode tick
    on each of ``tokens`` in turn (teacher forcing).  Returns the logits
    rows: the two chunks', then each tick's."""
    import numpy as np
    import torch
    from repro_torch.core.cdsp import prefill_chunk_paged
    from repro_torch.models.transformer import forward
    from repro_torch.serving.cache_manager import (PagedKVCache,
                                                   shard_block_table)
    page = 64
    L = len(prompt)
    l0 = L // 2
    # on a mesh context the pool stripes over the SP positions: logical
    # page j on shard j % n_sh, as the engine's BlockManager allocates
    n_sh = ctx.pool_shards("prefill")
    pages = -(-(L + len(tokens)) // page)
    n = -(-pages // n_sh) * n_sh                  # whole stripes
    kv = PagedKVCache(cfg, n, page, kv_shards=n_sh,
                      mesh=ctx.mesh if n_sh > 1 else None,
                      shard_axis=ctx.pool_axis("prefill"), device=ctx.device)
    bps = n // n_sh
    blocks = [(j % n_sh) * bps + j // n_sh for j in range(n)]
    dev = ctx.device
    toks = torch.as_tensor(prompt, device=dev)[None]
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None]
    out = []
    aux = None
    for off, ln in ((0, l0), (l0, L - l0)):
        lg, nc, aux = prefill_chunk_paged(
            params, cfg, ctx, toks[:, off:off + ln], pos[:, off:off + ln],
            kv.pools, blocks[:-(-off // page)], off, aux)
        kv.write_chunk(blocks, nc, pos[:, off:off + ln])
        out.append(lg[0, 0, :cfg.vocab_size].float())
        del nc
    bt = np.asarray(blocks, np.int32)[None]
    if n_sh > 1:
        bt = shard_block_table(bt, n_sh, bps)
    bt = torch.as_tensor(bt, device=dev)
    caches = {}
    for i, spec in enumerate(cfg.pattern):
        key = str(i)
        caches[key] = {"self": (
            {"k": kv.pools[key]["k"], "v": kv.pools[key]["v"],
             "block_table": bt[None].expand((cfg.n_blocks,) + bt.shape)}
            if spec.mixer == "attn" else aux[key]["self"])}
    for i, token in enumerate(tokens):
        clen = torch.tensor([L + i], dtype=torch.int32, device=dev)
        lg, _, caches = forward(params, cfg, ctx,
                                torch.tensor([[token]], device=dev),
                                clen[:, None], "decode", caches=caches,
                                cache_len=clen)
        out.append(lg[0, 0, :cfg.vocab_size].float())
    torch.cuda.synchronize()
    return out


def ssd_call_gate(run, n_layers: int):
    """Run ``run()``, two chunks of an attention-free Mamba model of
    ``n_layers`` layers on the kernel path, with each K5 call also held to
    the plain scan on the same inputs (that layer's activations) under
    K5's check; the kernel's outputs go on unchanged.  The second chunk's
    calls of the first and the last layer keep their inputs, and the
    check must reject each of ``SSD_FAULTS`` planted there.  Returns
    (``run()``'s result, a report whose ``ok`` says whether all calls
    passed and all planted faults were rejected)."""
    import statistics
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    kernel = ops.ssd_scan
    keep = {n_layers: "layer0_chunk2",
            2 * n_layers - 1: f"layer{n_layers - 1}_chunk2"}
    ratios, kept = [], {}

    def recorder(x, dt, A, Bm, Cm, *, h0=None, chunk=128):
        got = kernel(x, dt, A, Bm, Cm, h0=h0, chunk=chunk)
        ratios.append(ssd_ratios(got, ssd_scan_plain(
            x, dt, A, Bm, Cm, h0=h0, chunk=chunk)))
        if len(ratios) - 1 in keep:
            kept[keep[len(ratios) - 1]] = (x, dt, A, Bm, Cm, h0, chunk)
        return got

    ops.ssd_scan = recorder
    try:
        out = run()
    finally:
        ops.ssd_scan = kernel

    report = {"calls": len(ratios)}
    for k in ("y", "h") if ratios else ():
        i = max(range(len(ratios)), key=lambda i: ratios[i][k])
        report[f"worst_{k}"] = {"ratio": ratios[i][k], "layer": i % n_layers,
                                "chunk": i // n_layers + 1}
        report[f"median_{k}"] = statistics.median(r[k] for r in ratios)
    report["planted"] = {name: ssd_planted(*ins)
                         for name, ins in kept.items()}
    report["ok"] = (len(ratios) == 2 * n_layers
                    and all(r["y"] <= 1.0 and r["h"] <= 1.0 for r in ratios)
                    and len(kept) == len(keep)
                    and all(v > 1.0 for p in report["planted"].values()
                            for v in p.values()))
    return out, report


def paged_gate_plan(n_layers: int):
    """(calls, keep) of ``attn_call_gate`` for a served model's replay (two
    chunks, then a decode tick): K3 runs once a layer in each chunk (the
    second chunk's calls follow the first's), K2 in the second chunk, K1
    in the tick; the calls kept for planted faults are those of the first
    and the last layer."""
    return ({"flash_attention": 2 * n_layers, "paged_flash_prefill": n_layers,
             "paged_flash_decode": n_layers},
            {"flash_attention": (n_layers, 2 * n_layers - 1),
             "paged_flash_prefill": (0, n_layers - 1),
             "paged_flash_decode": (0, n_layers - 1)})


def whisper_gate_plan(n_enc: int, n_layers: int):
    """(calls, keep) of ``attn_call_gate`` for an encoder-decoder's
    prefill and first decode tick: K3 runs once a layer in the encoder,
    then twice a decoder layer (self attention, then cross attention); K4
    twice a decoder layer in the tick (self, then cross).  Kept: the
    encoder's first and last layer, the first decoder layer's self and
    cross calls and the last layer's cross call, and the tick's first
    self and cross calls and last cross call."""
    return ({"flash_attention": n_enc + 2 * n_layers,
             "flash_decode": 2 * n_layers},
            {"flash_attention": (0, n_enc - 1, n_enc, n_enc + 1,
                                 n_enc + 2 * n_layers - 1),
             "flash_decode": (0, 1, 2 * n_layers - 1)})


def attn_call_gate(run, want_calls: dict, keep: dict):
    """Run ``run()``, a kernel-path replay of a bf16 attention model, with
    each call of the kernels named in ``want_calls`` (K1-K4) also held to
    its plain version on the same inputs (that layer's activations, the
    pools as the call found them) under ``KERNEL_TOL``'s bf16 check; the
    kernels' outputs go on unchanged.  ``want_calls`` says how many calls
    of each kernel the replay makes; the calls whose indices ``keep``
    lists keep their inputs, and the check must reject V one key off
    planted there (``paged_gate_plan``, ``whisper_gate_plan``).  Returns
    (``run()``'s result, a report whose ``ok`` says whether every call
    passed and every planted fault was rejected)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_plain, paged_flash_prefill_plain)
    from repro_torch.kernels.flash_decode import (flash_decode_plain,
                                                  paged_flash_decode_plain)
    plains = {"flash_attention": flash_attention_plain,
              "paged_flash_prefill": paged_flash_prefill_plain,
              "paged_flash_decode": paged_flash_decode_plain,
              "flash_decode": flash_decode_plain}
    plains = {n: plains[n] for n in want_calls}
    kernels = {n: getattr(ops, n) for n in plains}
    calls = {n: [] for n in plains}
    kept = {}
    tol = KERNEL_TOL["bfloat16"]

    def ratios(got, want):
        return {"o": close_ratio(got[0], want[0], tol["atol"], tol["rtol"]),
                "lse": max_err(got[1], want[1]) / tol["lse"]}

    def recorder(name):
        def call(*args, **kw):
            ins = args
            if name == "paged_flash_decode":
                # the fused append writes the pools in place: the plain
                # version gets copies taken before the kernel's call
                ins = (args[0], args[1].clone(), args[2].clone()) + args[3:]
            got = kernels[name](*args, **kw)
            want = plains[name](*ins, **kw)
            if len(calls[name]) in keep[name]:
                kept[(name, len(calls[name]))] = (ins, kw, want)
            calls[name].append(ratios(got, want))
            return got
        return call

    for name in plains:
        setattr(ops, name, recorder(name))
    try:
        out = run()
    finally:
        for name, fn in kernels.items():
            setattr(ops, name, fn)

    report = {}
    for name, rs in calls.items():
        report[name] = {"calls": len(rs)}
        for k in ("o", "lse") if rs else ():
            i = max(range(len(rs)), key=lambda i: rs[i][k])
            report[name][f"worst_{k}"] = {"ratio": rs[i][k], "call": i}
    planted = {}
    for (name, i), (ins, kw, want) in kept.items():
        # V one key off: in a dense chunk along the keys, in a pool along
        # each page's slots
        bad = plains[name](*ins[:2], ins[2].roll(1, 1), *ins[3:], **kw)
        planted[f"{name}_call{i}"] = close_ratio(bad[0], want[0],
                                                 tol["atol"], tol["rtol"])
    report["planted_v_one_key_off"] = planted
    report["ok"] = (
        {n: len(rs) for n, rs in calls.items()} == want_calls
        and all(r[k] <= 1.0 for rs in calls.values() for r in rs
                for k in r)
        and len(planted) == sum(len(v) for v in keep.values())
        and all(v > 1.0 for v in planted.values()))
    return out, report


@contextlib.contextmanager
def moe_routes():
    """Record the routing of every MoE layer call made inside the block:
    yields a list that gains, per call, {"T": real tokens, "C": capacity,
    "top_idx": (n, g, k), "keep": (n, g, k)} (tensors left on the
    device), in call order: layer by layer within a forward, forward by
    forward.  The layer's results are not touched."""
    from repro_torch.models import moe
    route, group = moe._route, moe._group_tokens
    calls = []

    def group_rec(x, g):
        xt, T, pad = group(x, g)
        calls.append({"T": T})
        return xt, T, pad

    def route_rec(xt, router_w, m, E, C):
        r = route(xt, router_w, m, E, C)
        calls[-1].update(C=C, top_idx=r["top_idx"], keep=r["keep"])
        return r

    moe._route, moe._group_tokens = route_rec, group_rec
    try:
        yield calls
    finally:
        moe._route, moe._group_tokens = route, group


def _dropped(call) -> float:
    """Share of a call's (real token, choice) pairs dropped by capacity
    (padding rows, which also take capacity, left out)."""
    k = call["keep"].shape[-1]
    keep = call["keep"].reshape(-1, k)[:call["T"]]
    return float((~keep).sum()) / keep.numel()


def routing_summary(calls, n_layers: int, max_batch: int) -> dict:
    """What the routing did in a served run: for each prefill chunk, its
    tokens, capacity and dropped share (mean over layers, and the worst
    layer); for the decode ticks (``max_batch`` rows, idle rows included,
    as the engine routes them), the dropped share over all ticks and
    layers and the worst tick."""
    chunks, ticks = [], []
    for f in range(0, len(calls), n_layers):
        layers = calls[f:f + n_layers]
        shares = [_dropped(c) for c in layers]
        if layers[0]["T"] <= max_batch:
            ticks.append(sum(shares) / len(shares))
        else:
            chunks.append({"tokens": layers[0]["T"], "C": layers[0]["C"],
                           "dropped_share": sum(shares) / len(shares),
                           "worst_layer": max(shares)})
    return {"chunks": chunks, "ticks": {
        "count": len(ticks), "rows": max_batch,
        "dropped_share": sum(ticks) / len(ticks) if ticks else None,
        "worst_tick": max(ticks) if ticks else None}}


def routing_diff(got, want, n_layers: int, rows) -> dict:
    """Routing decisions that differ between two runs of the same
    forwards (``moe_routes`` records): per forward (named by ``rows``),
    per layer, the real tokens whose top-k expert set differs and the
    (token, choice) pairs whose capacity decision (keep) differs."""
    out = {}
    for f, row in enumerate(rows):
        sets, keeps = [], []
        for a, b in zip(got[f * n_layers:(f + 1) * n_layers],
                        want[f * n_layers:(f + 1) * n_layers]):
            k = a["top_idx"].shape[-1]
            ta = a["top_idx"].reshape(-1, k)[:a["T"]].sort(-1).values
            tb = b["top_idx"].reshape(-1, k)[:b["T"]].sort(-1).values
            sets.append(int((ta != tb).any(-1).sum()))
            keeps.append(int((a["keep"].reshape(-1, k)[:a["T"]]
                              != b["keep"].reshape(-1, k)[:b["T"]]).sum()))
        out[row] = {"tokens": got[f * n_layers]["T"],
                    "topk_set_differs": sets, "keep_differs": keeps}
    return out


# bf16 logits against the plain path: the two paths round at different
# places through 32 (Llama) or 48 (Mamba-2) layers, so logits drift by a
# few hundredths; hold the worst element to 0.25 and the direction of the
# whole row to a cosine limit.  Mamba-2's is 0.998: at 48 bf16 layers an
# exact float64 scan reads down to 0.99873 and right scans to 0.99854
# (PERF.md §6), so its scan is held per call instead (ssd_call_gate).
# Qwen1.5-MoE's is 0.98: an ulp of attention flips near-tied router
# choices (and, through capacity, drops other tokens), which moves a
# row's logits far more than rounding does; right paths read down to
# 0.98873 and planted faults at most 0.94567
# (tools/moe_logits_floor.py, PERF.md §6), so its attention kernels are
# held per call instead (attn_call_gate).
LOGIT_TOL = {"llama3-8b": {"max_abs_err": 0.25, "cos": 0.999},
             "mamba2-1.3b": {"max_abs_err": 0.25, "cos": 0.998},
             "qwen2-moe-a2.7b": {"max_abs_err": 0.25, "cos": 0.98},
             "chatglm3-6b": {"max_abs_err": 0.25, "cos": 0.999},
             "nemotron-4-15b": {"max_abs_err": 0.25, "cos": 0.999},
             "whisper-medium": {"max_abs_err": 0.25, "cos": 0.999}}


def _logits_vs_plain(phase, names, got, want, tol):
    import torch
    res = {}
    for name, a, b in zip(names, got, want):
        err = float((a - b).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        res[name] = {"max_abs_err": err, "cos": cos,
                     "ok": (err <= tol["max_abs_err"]
                            and cos >= tol["cos"])}
    emit(phase=phase, logits_vs_plain=res, tol=tol)
    check(all(r["ok"] for r in res.values()),
          f"{phase}: kernel-path logits disagree with the plain path")


def _serve_path(arch: str, path: str) -> dict:
    """Serve the smoke trace on ``arch`` at full width; returns the
    launch counts of the run."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.serving.simulator import summarize
    cfg = get_config(arch)
    ctx = make_context("cuda")
    # what an earlier path left on the card (its weights must be gone)
    before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=ctx.device)
    torch.cuda.synchronize()
    emit(phase="serve", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         d_model=cfg.d_model, params=count_params(params),
         init_s=round(time.perf_counter() - t0, 2),
         allocated_gib_before=round(before, 2))
    rng = np.random.default_rng(0)
    lens = [512, 2048, 4096, 6144]
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    out_len = 16
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    with moe_routes() as routes:
        eng = _serve(cfg, params, prompts, ctx, out_len, max_seq=6208,
                     prefill_pool_blocks=256, host_pool_blocks=128,
                     profile_ops=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    emit(phase="serve", model=cfg.name, launches=counts,
         wall_s=round(wall, 2),
         peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    _check_launches(counts, path)
    plans = {rid: r.chunk_plan for rid, r in eng.reqs.items()}
    check(all(len(p) == 2 for p in plans.values()),
          f"{cfg.name}: every request must run two chunks: {plans}")
    for rid, toks in eng.outputs.items():
        check(len(toks) >= out_len and all(0 <= t < cfg.vocab_size
                                           for t in toks),
              f"{cfg.name} request {rid}: bad output {toks}")
    s = summarize(eng.reqs)
    emit(phase="serve", model=cfg.name,
         plans={str(k): v for k, v in plans.items()},
         outputs={str(k): v for k, v in eng.outputs.items()},
         chunk_device_us=_hist(eng, "op_device_us/prefill_chunk"),
         tick_device_us=_hist(eng, "op_device_us/decode_tick"),
         scatter_device_us=_hist(eng, "op_device_us/scatter_chunk"),
         ttft_p50_s=s["ttft_p50"], ttft_p99_s=s["ttft_p99"],
         tbt_p50_s=s["tbt_p50"], clock="event")
    if cfg.moe is not None:
        # what capacity did to the served tokens (decode ticks route their
        # rows as one group of 4: capacity 1 per expert)
        emit(phase="serve", model=cfg.name,
             routing=routing_summary(routes, cfg.n_layers, 4))
    del routes
    first_tokens = {rid: toks[0] for rid, toks in eng.outputs.items()}
    del eng
    _free()

    # the plain path on the same weights, replaying the longest request;
    # on Mamba-2 each K5 call of the kernel-path replay is also held to the
    # plain scan on its own inputs
    rid = len(lens) - 1

    def replay():
        return _replay(cfg, params, ctx, prompts[rid], [first_tokens[rid]])

    with moe_routes() as got_routes:
        if path == "serve_mamba":
            got, gate = ssd_call_gate(replay, cfg.n_layers)
        elif path in ATTN_GATED:
            got, gate = attn_call_gate(replay, *paged_gate_plan(
                cfg.n_layers))
        else:
            got = replay()
    if path == "serve_mamba":
        emit(phase="serve", model=cfg.name, ssd_calls=gate,
             tol={k: SSD_TOL[k] for k in ("bfloat16", "h_final")})
        check(gate["ok"], f"{cfg.name}: a K5 call of the replay disagrees "
              "with the plain scan, or a planted fault passed: "
              f"{gate}")
    if path in ATTN_GATED:
        emit(phase="serve", model=cfg.name, attention_calls=gate,
             tol=KERNEL_TOL["bfloat16"])
        check(gate["ok"], f"{cfg.name}: a K1-K3 call of the replay "
              "disagrees with its plain version, or a planted fault "
              f"passed: {gate}")
    check(int(torch.argmax(got[1])) == first_tokens[rid],
          f"{cfg.name}: replayed prefill disagrees with the engine's first "
          "token")
    with moe_routes() as want_routes:
        want = _replay(cfg, params, ctx.with_(impl="ref"), prompts[rid],
                       [first_tokens[rid]])
    if cfg.moe is not None:
        # bf16 attention differs between the paths by an ulp here and
        # there, which can flip a near-tied router choice
        emit(phase="serve", model=cfg.name, routing_vs_plain=routing_diff(
            got_routes, want_routes, cfg.n_layers,
            ("chunk1", "chunk2_history", "decode_tick")))
    del got_routes, want_routes
    _logits_vs_plain("serve", ("chunk1", "chunk2_history", "decode_tick"),
                     got, want, LOGIT_TOL[arch])
    del params
    _free()
    return counts


def phase_serve() -> dict:
    # each path frees its weights before the next one starts
    return {"serve_llama": _serve_path("llama3-8b", "serve_llama"),
            "serve_mamba": _serve_path("mamba2-1.3b", "serve_mamba"),
            "serve_moe": _serve_path("qwen2-moe-a2.7b", "serve_moe"),
            "serve_chatglm": _serve_path("chatglm3-6b", "serve_chatglm"),
            "serve_nemotron": _serve_path("nemotron-4-15b",
                                          "serve_nemotron")}


# ------------------------------------------------------- phase 3b: serve_sp
SP = 4            # mesh positions of the sequence-parallel serve phase


def _sp_context(impl=None):
    """The serving engine's mesh context: ``SP`` positions, every one on
    the one card (``cuda:0``), both pools striped over them."""
    from repro_torch.launch.mesh import make_context, make_mesh
    return make_context(make_mesh((SP,), ("data",), device="cuda"),
                        "serve_paged", impl=impl)


def sp_gate_plan(n_layers: int):
    """(calls, keep) of ``attn_call_gate`` for the sharded replay (two
    chunks, then a decode tick) on ``SP`` positions.  Chunk 1 rings over
    its own KV: SP positions x SP steps K3 calls a layer, in the order
    (step, position).  Chunk 2 adds each shard's history slab: two K3
    calls a position and step (own KV, then slab).  The tick runs K1 once
    a shard and layer.  Kept for planted faults: chunk 2's first own and
    slab calls (layer 0, position 0, step 0) and its last two (the last
    layer, position SP - 1, step SP - 1, whose KV and slab came from
    position 0), and the tick's first and last calls."""
    c1 = SP * SP * n_layers
    c2 = 2 * SP * SP * n_layers
    return ({"flash_attention": c1 + c2, "paged_flash_decode": SP * n_layers},
            {"flash_attention": (c1, c1 + 1, c1 + c2 - 2, c1 + c2 - 1),
             "paged_flash_decode": (0, SP * n_layers - 1)})


def _k3_ring_step_times(cfg, L: int) -> dict:
    """One K3 call's time at the ring-step shapes of the longest request's
    history chunk (``L / 2`` queries over ``L / 2`` history tokens, a
    ring step of ``L / (2 SP)`` queries): over own-chunk keys on the
    diagonal (causal), over keys of an earlier position (all visible),
    and over a shard's history slab (positions striped by page, the dead
    slots at INT32_MAX), each beside its bound and its plain version."""
    import torch
    from repro_torch.core.ring_attention import INT32_MAX
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    H, KVH, D = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim_
    half = L // 2
    s = half // SP                                   # queries a position

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    q, k, v = randn(1, s, H, D), randn(1, s, KVH, D), randn(1, s, KVH, D)
    qp = torch.arange(half, half + s, dtype=torch.int32, device=dev)
    page = 64
    gpage = torch.arange(s // page, dtype=torch.int32, device=dev) * SP
    slab = (gpage[:, None] * page + torch.arange(
        page, dtype=torch.int32, device=dev)[None]).reshape(-1)
    cases = {"own_diagonal": (qp, qp), "own_earlier": (qp, qp - s),
             "history_slab": (qp, torch.where(
                 slab < half, slab, torch.full_like(slab, INT32_MAX)))}
    # a fixed warm-up of every case, then two passes.  ``ms`` is the
    # per-call event time with the card held busy (``event_ms``): it reads
    # the same fresh and after the serve phase, where the profiler's sum
    # reads ~0.6x of it (PERF.md section 6), so the profiler's is only
    # printed beside it, as is the SM clock read while the card spins
    for _ in range(200):
        for a, b in cases.values():
            flash_attention(q, k, v, a, b)
    torch.cuda.synchronize()
    out = {name: {"queries": s, "keys": s, "ms_passes": [],
                  "profiler_ms_passes": []} for name in cases}
    clocks = []
    for _ in range(2):
        for name, (a, b) in cases.items():
            fn = (lambda a=a, b=b: flash_attention(q, k, v, a, b))
            out[name]["ms_passes"].append(event_ms(fn, cold=False))
            out[name]["profiler_ms_passes"].append(time_ms(fn)[0])
        torch.cuda._sleep(1_000_000_000)            # ~0.5 s of spinning
        clocks.append(_sm_clock())
        torch.cuda.synchronize()
    for name, (a, b) in cases.items():
        pairs = int((b[None, :] <= a[:, None]).sum())
        nbytes = (2 * s * H * D + 2 * s * KVH * D) * 2 + H * s * 4 + 2 * s * 4
        bms, by = bound_ms(nbytes, 4 * H * D * pairs, "bfloat16")
        plain = (lambda a=a, b=b: flash_attention_plain(q, k, v, a, b))
        out[name].update(visible_pairs=pairs, ms=out[name]["ms_passes"][-1],
                         plain_ms=event_ms(plain, cold=False, n=3),
                         bound_ms=bms, bound_by=by)
    out["sm_clock_mhz_busy"] = clocks
    return out


def _sm_clock() -> str:
    """The card's SM clock and its maximum, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


# Two numerically different bf16 paths through 32 layers give top scores
# (near 0.79, where a bf16 ulp is 2^-8) that differ by up to 3 ulps
# (0.0117 on an H100, between the unsharded, sharded and plain rows:
# PERF.md section 6), and these seeded weights leave many steps with two
# tokens closer than that: there greedy streams may part.  A step where a
# path's argmax is not the stream's token is accepted as a tie when every
# path scores the two tokens within TIE_TOL = 2^-5, 8 ulps: over twice
# that difference.
TIE_TOL = 2 ** -5


def _stream_ties(cfg, params, ctxs: dict, prompts, want: dict, got: dict):
    """Teacher-force each request's whole stream in ``want`` on every path
    (``ctxs``: name -> context) and hold every step: each path's argmax
    must be ``want``'s token, or the step a tie, every path scoring the two
    tokens within TIE_TOL.  The step where ``got``'s stream first parts
    from ``want``'s is held to the same rule with ``got``'s token; after
    it ``got`` runs on another prefix, and the paths' rows on ``want``'s
    prefix are what is checked.  Returns per request: the steps checked,
    the first parting, each step and token other than ``want``'s (each
    path's score gap, ``tie``), and the largest row difference between
    each two paths."""
    import itertools
    import torch
    out = {}
    for rid, a in want.items():
        b = got[rid]
        part = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        rows = {n: torch.stack(_replay(cfg, params, c, prompts[rid],
                                       a[:-1])[1:])
                for n, c in ctxs.items()}
        others = []
        for t, tok in enumerate(a):
            alt = {int(r[t].argmax()) for r in rows.values()}
            if t == part:
                alt.add(b[t])
            for g in sorted(alt - {tok}):
                gaps = {n: abs(float(r[t, tok] - r[t, g]))
                        for n, r in rows.items()}
                others.append({
                    "step": t, "tokens": [tok, g],
                    "argmax": [n for n, r in rows.items()
                               if int(r[t].argmax()) == g],
                    "engine": t == part and g == b[t], "gaps": gaps,
                    "tie": max(gaps.values()) <= TIE_TOL})
        out[rid] = {
            "steps": len(a), "parting": part, "others": others,
            "max_abs_err": {f"{m}-{n}": float((rows[m] - rows[n]).abs().max())
                            for m, n in itertools.combinations(rows, 2)},
            "top_score_err": {
                f"{m}-{n}": float((rows[m].max(-1).values
                                   - rows[n].max(-1).values).abs().max())
                for m, n in itertools.combinations(rows, 2)}}
        del rows
        _free()
    return out


def phase_serve_sp() -> dict:
    """Llama-3-8B at full width, bf16, served by the ServingEngine on a
    4-position mesh of the one card: the smoke trace of the serve phase
    (prompts of 512-6144 tokens, two chunks each, pages of 64, max_batch
    4) through ring attention (chunk 1), ring-paged prefill over the
    striped history (chunk 2) and the split-KV paged decode (ticks).  In
    bf16 the greedy streams may part at a tie: every step of the unsharded
    engine's streams is held on the unsharded, sharded and plain paths by
    ``_stream_ties``.  The longest
    request's replay holds each K1/K3 call to its plain version with
    planted faults, and its logits to the plain path's.  Returns the
    launch counts of the sharded run."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.sharding import make_context
    cfg = get_config("llama3-8b")
    ctx = make_context("cuda")
    sp_ctx = _sp_context()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=ctx.device)
    torch.cuda.synchronize()
    emit(phase="serve_sp", model=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, d_model=cfg.d_model,
         params=count_params(params), positions=SP,
         mesh=repr(sp_ctx.mesh), init_s=round(time.perf_counter() - t0, 2))
    rng = np.random.default_rng(0)
    lens = [512, 2048, 4096, 6144]
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    out_len = 16
    runs = {}
    for name, c in (("unsharded", ctx), ("sharded", sp_ctx)):
        _free()
        _reset_counts()
        t0 = time.perf_counter()
        eng = _serve(cfg, params, prompts, c, out_len, max_seq=6208,
                     prefill_pool_blocks=256, host_pool_blocks=128,
                     profile_ops=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = {"launches": _read_counts(),
                      "outputs": dict(eng.outputs),
                      "plans": {rid: r.chunk_plan
                                for rid, r in eng.reqs.items()},
                      "kv_shards": (eng.pkv.kv_shards,
                                    eng.dstates[0].kv_shards),
                      "chunk_device_us": _hist(
                          eng, "op_device_us/prefill_chunk"),
                      "tick_device_us": _hist(eng,
                                              "op_device_us/decode_tick")}
        emit(phase="serve_sp", model=cfg.name, engine=name,
             wall_s=round(wall, 2), **{k: v for k, v in runs[name].items()
                                       if k not in ("outputs", "plans")},
             outputs={str(k): v for k, v in eng.outputs.items()})
        del eng
    sh, flat = runs["sharded"], runs["unsharded"]
    counts = sh["launches"]
    _check_launches(counts, "serve_sp")
    check(sh["kv_shards"] == (SP, SP),
          f"serve_sp: pools striped {sh['kv_shards']}, not {SP} ways")
    check(all(len(p) == 2 for p in sh["plans"].values()),
          f"serve_sp: every request must run two chunks: {sh['plans']}")
    emit(phase="serve_sp", model=cfg.name,
         device_ms={f"{op}_mean": {
             k: r[f"{op}_device_us"]["mean"] / 1e3
             for k, r in runs.items() if r[f"{op}_device_us"]}
             for op in ("chunk", "tick")},
         tokens_identical={str(r): sh["outputs"][r] == t
                           for r, t in flat["outputs"].items()})
    # in bf16 every step of every stream is held: the paths agree on the
    # unsharded engine's token or the step is a tie (TIE_TOL); exact token
    # identity is held in fp32 (phase tokens)
    ties = _stream_ties(cfg, params, {"unsharded": ctx, "sharded": sp_ctx,
                                      "plain": ctx.with_(impl="ref")},
                        prompts, flat["outputs"], sh["outputs"])
    emit(phase="serve_sp", model=cfg.name, stream_ties=ties,
         tie_tol=TIE_TOL, steps_checked=sum(r["steps"] for r in ties.values()))
    check(all(o["tie"] for r in ties.values() for o in r["others"]),
          "serve_sp: a path's greedy token differs from the unsharded "
          f"engine's at a step that is no tie: {ties}")

    # the longest request replayed on the mesh, each K1/K3 call held to its
    # plain version, and its logits to the plain (unsharded) path's
    rid = len(lens) - 1
    first = flat["outputs"][rid][0]
    _free()
    want_calls, keep = sp_gate_plan(cfg.n_layers)
    got, gate = attn_call_gate(
        lambda: _replay(cfg, params, sp_ctx, prompts[rid], [first]),
        want_calls, keep)
    per = {"chunk1_K3": SP * SP * cfg.n_layers,
           "chunk2_K3": 2 * SP * SP * cfg.n_layers,
           "tick_K1": SP * cfg.n_layers}
    L = lens[rid]
    pages = -(-(L + 1) // 64)
    emit(phase="serve_sp", model=cfg.name, attention_calls=gate,
         tol=KERNEL_TOL["bfloat16"], launches_per_step=per,
         shard_shapes={"K3_queries": L // 2 // SP,
                       "K3_own_keys": L // 2 // SP,
                       "K3_slab_keys": L // 2 // SP,
                       "K1_table_cols": -(-pages // SP)})
    check(gate["ok"], "serve_sp: a K1/K3 call of the sharded replay "
          f"disagrees with its plain version, or a planted fault passed: "
          f"{gate}")
    check(int(torch.argmax(got[1])) == first,
          "serve_sp: the sharded replay disagrees with the engine's first "
          "token")
    want = _replay(cfg, params, ctx.with_(impl="ref"), prompts[rid],
                   [first])
    _logits_vs_plain("serve_sp", ("chunk1", "chunk2_history", "decode_tick"),
                     got, want, LOGIT_TOL["llama3-8b"])
    del got, want
    _free()
    emit(phase="serve_sp", model=cfg.name,
         k3_ring_step=_k3_ring_step_times(cfg, L))
    del params
    _free()
    return counts


# ---------------------------------------------------------------- phase 4
def _dense_run(cfg, params, ctx, prompts, chunks, ticks, force=None,
               frames=None):
    """CDSP chunked prefill over a dense history (an encoder-decoder's
    with its ``frames``), the hand-off to dense decode caches, then
    ``ticks`` dense decode ticks, greedy (or on the tokens ``force``).
    ``prompts``: one prompt, or a batch of prompts of one length.  Returns
    a dict: ``rows`` (logits (B, V) fp32: prefill then each tick),
    ``tokens`` (a list of B tokens per step), ``prefill_ms`` and
    ``tick_ms`` (CUDA events around the prefill with its hand-off, and
    around each tick), ``prefill_launches`` (the kernels the prefill and
    hand-off launched)."""
    import numpy as np
    import torch
    from repro_torch.core.cdsp import (chunked_prefill,
                                       history_to_decode_caches)
    from repro_torch.models.transformer import forward
    dev = ctx.device
    toks = torch.as_tensor(np.atleast_2d(prompts), device=dev)
    B, L = toks.shape
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None].expand(B, L)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    before = _read_counts()
    ev[0].record()
    logits, hist = chunked_prefill(params, cfg, ctx, toks, pos, chunks,
                                   encoder_frames=frames)
    caches, clen = history_to_decode_caches(cfg, hist, max_seq=L + ticks)
    ev[1].record()
    prefill_launches = {k: v - before[k] for k, v in _read_counts().items()}
    del hist
    rows = [logits[:, 0, :cfg.vocab_size].float()]
    out = [rows[0].argmax(-1).tolist() if force is None else force[0]]
    tick_ms = []
    for i in range(ticks):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        lg, _, caches = forward(params, cfg, ctx,
                                torch.tensor(out[-1], device=dev)[:, None],
                                clen[:, None], "decode", caches=caches,
                                cache_len=clen)
        b.record()
        clen = clen + 1
        rows.append(lg[:, 0, :cfg.vocab_size].float())
        out.append(rows[-1].argmax(-1).tolist() if force is None
                   else force[i + 1])
        tick_ms.append((a, b))
    torch.cuda.synchronize()
    return {"rows": rows, "tokens": out,
            "prefill_ms": ev[0].elapsed_time(ev[1]),
            "tick_ms": [a.elapsed_time(b) for a, b in tick_ms],
            "prefill_launches": prefill_launches}


def phase_dense() -> dict:
    """Llama-3-8B at full width: a 6144-token prompt prefilled as two CDSP
    chunks over a dense history (K3 over the concatenated KV), handed to
    dense decode caches, then 16 dense decode ticks (K4)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    cfg = get_config("llama3-8b")
    ctx = make_context("cuda")
    params = init_params(cfg, seed=0, device=ctx.device)
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, 6144).astype(np.int32)
    ticks = 16
    chunks = [len(prompt) // 2, len(prompt) - len(prompt) // 2]
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    run = _dense_run(cfg, params, ctx, prompt, chunks, ticks)
    counts = _read_counts()
    tick_ms = run["tick_ms"]
    toks = [t[0] for t in run["tokens"]]
    emit(phase="dense", model=cfg.name, chunks=chunks, ticks=ticks,
         launches=counts, prefill_device_ms=run["prefill_ms"],
         tick_device_ms={"mean": sum(tick_ms) / len(tick_ms),
                         "min": min(tick_ms), "max": max(tick_ms)},
         peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2),
         tokens=toks, clock="cuda events around each call")
    _check_launches(counts, "dense")
    check(counts["flash_decode"] == cfg.n_layers * ticks,
          f"dense: K4 launched {counts['flash_decode']} times, want "
          f"{cfg.n_layers * ticks}")
    want = _dense_run(cfg, params, ctx.with_(impl="ref"), prompt, chunks, 1,
                      force=run["tokens"][:2])
    _logits_vs_plain("dense", ("prefill_chunk2", "decode_tick1"),
                     [r[0] for r in run["rows"][:2]],
                     [r[0] for r in want["rows"]], LOGIT_TOL["llama3-8b"])
    del params
    _free()
    return counts


# ---------------------------------------------------------- phase whisper
# Whisper-medium's smoke: four 30-s audio segments (1500 encoder frames
# each, from the stubbed frontend), a 224-token previous-text prompt each
# (half the decoder's 448-token context), then 32 greedy dense decode ticks
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_TICKS = 4, 224, 32


def _whisper_inputs(cfg, seed: int, device):
    """Seeded encoder frames (B, cross_kv_len, d_model) fp32 on ``device``
    and B decoder prompts of ``WHISPER_PROMPT`` tokens."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.standard_normal(
        (WHISPER_BATCH, cfg.cross_kv_len, cfg.d_model)).astype(np.float32))
    prompts = rng.integers(0, cfg.vocab_size,
                           (WHISPER_BATCH, WHISPER_PROMPT)).astype(np.int32)
    return frames.to(device), prompts


def _whisper_params(cfg, seed: int, device) -> dict:
    """Seeded Whisper weights: ``init_params`` (the reference's rules),
    then the decoder's token table drawn at std 1 and the cross-attention
    biases set to zero.  Under the reference's rules the table's std is
    1/sqrt(vocab), which puts the decoder's input some 200x below its
    attention outputs, and the ``x_b*`` biases are drawn at std
    1/sqrt(n_layers) (their names do not start with "b"): the two-layer
    fp32 model of the tokens phase then greedy-decodes one and the same
    token for every request and tick, and its token check would compare
    constants.  (At 24 layers the greedy tokens barely depend on the
    input under either rule: 3 distinct tokens over the whisper phase's
    4 requests x 33 steps, on the card.)"""
    import torch
    from repro_torch.models.params import init_params
    params = init_params(cfg, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    params["embed"].normal_(0.0, 1.0, generator=gen)
    for name in ("x_bq", "x_bk", "x_bv"):
        params["blocks"]["0"][name].zero_()
    return params


def phase_whisper() -> dict:
    """Whisper-medium at published widths (bf16, 24 encoder and 24 decoder
    layers, seeded weights): the decoder prompts prefill as one CDSP chunk
    with the encoder frames (K3: the encoder's self attention, then each
    decoder layer's self and cross attention), the hand-off carries the
    cross KV into the dense decode caches, and each tick runs K4 twice a
    layer (self attention over the dense cache, cross attention over the
    1500 frames' KV).  The prefill and first tick are replayed with every
    K3/K4 call held to its plain version, and their logits held to the
    plain path's."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import count_params
    from repro_torch.models.sharding import make_context
    cfg = get_config("whisper-medium")
    ctx = make_context("cuda")
    params = _whisper_params(cfg, 0, ctx.device)
    frames, prompts = _whisper_inputs(cfg, 0, ctx.device)
    L, ticks = WHISPER_PROMPT, WHISPER_TICKS
    emit(phase="whisper", model=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
         d_model=cfg.d_model, head_dim=cfg.head_dim_,
         params=count_params(params), batch=WHISPER_BATCH,
         encoder_frames=cfg.cross_kv_len, prompt=L, ticks=ticks)
    # one untimed prefill and tick first: the first call of each of the
    # run's GEMM shapes loads its kernel (on an H100 a cold first prefill
    # read 332 ms between events, a warm one 64-82 ms)
    _dense_run(cfg, params, ctx, prompts, [L], 1, frames=frames)
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    run = _dense_run(cfg, params, ctx, prompts, [L], ticks, frames=frames)
    counts = _read_counts()
    pre = run["prefill_launches"]
    per_tick = {k: (counts[k] - pre[k]) / ticks for k in counts}
    tick_ms = run["tick_ms"]
    emit(phase="whisper", model=cfg.name, launches=counts,
         prefill_launches=pre, launches_per_tick=per_tick,
         prefill_device_ms=run["prefill_ms"],
         tick_device_ms={"mean": sum(tick_ms) / len(tick_ms),
                         "min": min(tick_ms), "max": max(tick_ms)},
         peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2),
         clock="cuda events around each call")
    _check_launches(counts, "whisper")
    want_pre = cfg.n_encoder_layers + 2 * cfg.n_layers
    check(pre == {**{k: 0 for k in pre}, "flash_attention": want_pre},
          f"whisper: prefill launched {pre}, want K3 x {want_pre} only")
    check(per_tick == {**{k: 0 for k in per_tick},
                       "flash_decode": 2 * cfg.n_layers},
          f"whisper: a tick launched {per_tick}, want K4 x "
          f"{2 * cfg.n_layers} only")
    check(all(0 <= t < cfg.vocab_size for step in run["tokens"]
              for t in step), "whisper: a token outside the vocabulary")
    emit(phase="whisper", model=cfg.name, distinct_tokens=len(
        {t for step in run["tokens"] for t in step}),
         tokens_by_request=[[step[b] for step in run["tokens"]]
                            for b in range(WHISPER_BATCH)])
    check(all(bool(torch.isfinite(r).all()) for r in run["rows"]),
          "whisper: non-finite logits")

    # the prefill and the first tick again, each K3/K4 call held to its
    # plain version on its own inputs, then on the plain path
    force = run["tokens"][:2]

    def replay():
        return _dense_run(cfg, params, ctx, prompts, [L], 1, force=force,
                          frames=frames)

    got, gate = attn_call_gate(replay, *whisper_gate_plan(
        cfg.n_encoder_layers, cfg.n_layers))
    emit(phase="whisper", model=cfg.name, attention_calls=gate,
         tol=KERNEL_TOL["bfloat16"])
    check(gate["ok"], f"{cfg.name}: a K3/K4 call of the replay disagrees "
          f"with its plain version, or a planted fault passed: {gate}")
    check(got["tokens"][0] == run["tokens"][0],
          "whisper: the replayed prefill disagrees with the run's tokens")
    want = _dense_run(cfg, params, ctx.with_(impl="ref"), prompts, [L], 1,
                      force=force, frames=frames)
    names = [f"{step}_req{b}" for step in ("prefill", "decode_tick1")
             for b in range(WHISPER_BATCH)]
    _logits_vs_plain("whisper", names,
                     [r for rows in run["rows"][:2] for r in rows],
                     [r for rows in want["rows"] for r in rows],
                     LOGIT_TOL[cfg.name])
    del params, got, want, run
    _free()
    return counts


def _tokens_whisper(seed: int, ticks: int = 8) -> None:
    """fp32 Whisper-medium at two encoder and two decoder layers (full
    widths): the kernel path and the plain path give identical greedy
    tokens over the prefill and ``ticks`` ticks."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.sharding import make_context
    cfg = dataclasses.replace(get_config("whisper-medium"), n_layers=2,
                              n_encoder_layers=2, dtype="float32")
    ctx = make_context("cuda")
    params = _whisper_params(cfg, seed, ctx.device)
    frames, prompts = _whisper_inputs(cfg, seed, ctx.device)
    outs = {}
    for impl in (None, "ref"):
        _reset_counts()
        toks = _dense_run(cfg, params, ctx.with_(impl=impl), prompts,
                          [prompts.shape[1]], ticks, frames=frames)["tokens"]
        counts = _read_counts()
        outs[impl or "cuda"] = toks
        emit(phase="tokens", model=cfg.name, impl=impl or "cuda",
             launches=counts, outputs=toks)
        if impl is None:
            _check_launches(counts, "whisper")
        else:
            check(not any(counts.values()),
                  f"{cfg.name}: plain path launched kernels: {counts}")
    same = outs["cuda"] == outs["ref"]
    emit(phase="tokens", model=cfg.name, identical=same)
    check(same, f"{cfg.name}: fp32 greedy tokens differ between kernel and "
          "plain paths")
    del params
    _free()


# ---------------------------------------------------------------- phase 5
def _tokens_engine(arch: str, path: str, seed: int, lens, out_len: int):
    """fp32 at two layers and full widths: the engine's greedy tokens on
    the kernel path and on the plain path.  Returns (cfg, params, ctx,
    prompts, kernel-path outputs)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    ctx = make_context("cuda")
    params = init_params(cfg, seed=seed, device=ctx.device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    outs = {}
    for impl in (None, "ref"):
        _reset_counts()
        eng = _serve(cfg, params, prompts, ctx.with_(impl=impl), out_len,
                     max_seq=4096, prefill_pool_blocks=160,
                     host_pool_blocks=64)
        counts = _read_counts()
        outs[impl or "cuda"] = dict(eng.outputs)
        emit(phase="tokens", model=cfg.name, impl=impl or "cuda",
             launches=counts,
             outputs={str(k): v for k, v in eng.outputs.items()})
        if impl is None:
            _check_launches(counts, path)
        else:
            check(not any(counts.values()),
                  f"{cfg.name}: plain path launched kernels: {counts}")
        del eng
        _free()
    same = outs["cuda"] == outs["ref"]
    emit(phase="tokens", model=cfg.name, identical=same)
    check(same, f"{cfg.name}: fp32 greedy tokens differ between kernel and "
          "plain paths")
    return cfg, params, ctx, prompts, outs["cuda"]


def _tokens_sharded(cfg, params, prompts, outs, out_len: int) -> None:
    """The same fp32 trace on the ``SP``-position mesh engine: chunks of
    150 and 1250 tokens do not divide over the ring and take the striped
    history's gather fallback (K3 over slab ++ chunk), the others ring;
    the tokens must be the unsharded kernel and plain engines'."""
    _reset_counts()
    eng = _serve(cfg, params, prompts, _sp_context(), out_len,
                 max_seq=4096, prefill_pool_blocks=160, host_pool_blocks=64)
    counts = _read_counts()
    _check_launches(counts, "serve_sp")
    same = dict(eng.outputs) == outs
    emit(phase="tokens", model=cfg.name, impl="cuda", positions=SP,
         launches=counts, identical=same,
         outputs={str(k): v for k, v in eng.outputs.items()})
    check(same, f"{cfg.name}: fp32 greedy tokens of the {SP}-position "
          "mesh engine differ from the unsharded engines'")
    del eng
    _free()


def phase_tokens():
    cfg, params, ctx, prompts, outs = _tokens_engine(
        "llama3-8b", "serve_llama", 1, (300, 1000, 2500, 4000), 8)
    _tokens_sharded(cfg, params, prompts, outs, 8)
    # Llama's dense path (K3 + K4) on one of the same prompts gives the
    # paged engine's tokens (K1-K3)
    rid = 2
    L = len(prompts[rid])
    _reset_counts()
    dense = [t[0] for t in _dense_run(cfg, params, ctx, prompts[rid],
                                      [L // 2, L - L // 2],
                                      len(outs[rid]) - 1)["tokens"]]
    counts = _read_counts()
    _check_launches(counts, "dense")
    emit(phase="tokens", model=cfg.name, path="dense", launches=counts,
         dense=dense, paged=outs[rid], identical=dense == outs[rid])
    check(dense == outs[rid], "fp32 dense-path tokens differ from the paged "
          "engine's")
    del params
    _free()
    _tokens_engine("mamba2-1.3b", "serve_mamba", 2, (300, 1000, 2500, 4000),
                   8)
    _tokens_engine("qwen2-moe-a2.7b", "serve_moe", 3,
                   (300, 1000, 2500, 4000), 8)
    _tokens_engine("chatglm3-6b", "serve_chatglm", 4,
                   (300, 1000, 2500, 4000), 8)
    _tokens_engine("nemotron-4-15b", "serve_nemotron", 5,
                   (300, 1000, 2500, 4000), 8)
    _tokens_whisper(6)


# ---------------------------------------------------------- profile (opt-in)
# K2/K3's kernels in flash_attention.cu: the tensor-core kernel (bf16) and
# the CUDA-core kernel (fp32), templated on <head_dim, paged>
_ATTN_SYMBOL = re.compile(r"attn_(tc|simt)_kernel<\d+, (true|false)\b")


def _kernel_groups(prof, decode: str = "K1 paged_flash_decode") -> dict:
    """Device time (ms) by kernel group from a torch.profiler run, and the
    largest ungrouped kernels by name.  The decode kernels (split and
    merge) are K1's and K4's alike: ``decode`` names their group."""
    groups, others = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if (not us or ev.device_type.name not in ("CUDA", "PrivateUse1")
                or getattr(ev, "is_user_annotation", False)):
            continue
        name = ev.key
        attn = _ATTN_SYMBOL.search(name)
        g = (("K2 paged_flash_prefill" if attn.group(2) == "true"
              else "K3 flash_attention") if attn else
             decode if "decode_" in name else
             "K5 ssd_scan" if "ssd_" in name else
             "gemm" if any(t in name.lower() for t in
                           ("gemm", "nvjet", "sm90_", "cutlass"))
             else "other")
        groups[g] = groups.get(g, 0.0) + us / 1e3
        if g == "other":
            others[name[:60]] = others.get(name[:60], 0.0) + us / 1e3
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    return groups, dict(top)


def _device_ms_by_op(prof, n: int = 10) -> dict:
    """Device time (ms) of the kernels each aten op launched itself, the
    ``n`` largest: the elementwise work named by op, where its kernels'
    names are templates shared by many ops.  The port's own kernels run
    under no aten op."""
    ops = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and ev.device_type.name == "CPU" and ev.key.startswith("aten::"):
            ops[ev.key] = ops.get(ev.key, 0.0) + us / 1e3
    return dict(sorted(ops.items(), key=lambda kv: -kv[1])[:n])


# the MoE layer's stages, each profiled as a range of its own: the
# router's product, softmax, top-k and capacity order; the dispatch one-hot
# and product; the routed experts' GEMMs and activation; the combine; the
# shared experts' MLP
MOE_STAGES = {"_route": "moe/route", "_dispatch_einsum": "moe/dispatch",
              "_expert_ffn": "moe/experts", "_combine_einsum": "moe/combine",
              "mlp": "moe/shared"}


@contextlib.contextmanager
def _moe_ranges():
    """Inside the block each MoE stage runs under a profiler range named
    in ``MOE_STAGES``; the results are not touched."""
    from torch.profiler import record_function
    from repro_torch.models import moe
    saved = {k: getattr(moe, k) for k in MOE_STAGES}

    def ranged(fn, label):
        def run(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return run

    for k, label in MOE_STAGES.items():
        setattr(moe, k, ranged(saved[k], label))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(moe, k, fn)


def _range_ms(prof) -> dict:
    """Device time (ms) of the kernels launched inside each MoE stage's
    range (``_moe_ranges``)."""
    out = {}
    for ev in prof.key_averages():
        if ev.device_type.name == "CPU" and ev.key in MOE_STAGES.values():
            out[ev.key] = out.get(ev.key, 0.0) + ev.device_time_total / 1e3
    return out


def _profile(model: str, windows,
             decode: str = "K1 paged_flash_decode") -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    for name, fn, reps, need in windows:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        bare = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        groups, others = _kernel_groups(prof, decode)
        groups = {k: v / reps for k, v in groups.items()}
        ops = _device_ms_by_op(prof)
        stages = {k: v / reps for k, v in _range_ms(prof).items()}
        busy = sum(groups.values())
        emit(phase="profile", model=model, window=name, wall_ms=wall,
             wall_ms_no_profiler=bare, kernel_ms=groups, busy_ms=busy,
             idle_share=(1.0 - busy / wall) if busy else None,
             idle_share_no_profiler=(1.0 - busy / bare) if busy else None,
             top_other_ms={k: v / reps for k, v in others.items()},
             top_ops_ms={k: v / reps for k, v in ops.items()},
             **({"moe_stage_ms": stages} if stages else {}))
        check(all(groups.get(g, 0.0) > 0.0 for g in need),
              f"profile {model}/{name}: no device time under {need}: "
              f"{groups}")


def _profile_attention(arch: str, lens, page: int = 64) -> None:
    """Profile one full-width attention model: the second half of the
    6144-token prompt over 3072 history tokens in pages (K2 + K3), and the
    smoke batch's decode tick (one fused step, K1)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cdsp import prefill_chunk_paged
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.models.transformer import forward
    from repro_torch.serving.cache_manager import PagedKVCache
    ctx = make_context("cuda")
    dev = ctx.device
    cfg = get_config(arch)
    params = init_params(cfg, seed=0, device=dev)
    npg = -(-(max(lens) + 16) // page)
    kv = PagedKVCache(cfg, len(lens) * npg, page, device=dev)
    for p in ("k", "v"):
        kv.pools["0"][p].normal_()
    table = torch.arange(len(lens) * npg, dtype=torch.int32,
                         device=dev).reshape(len(lens), npg)
    toks = torch.randint(0, cfg.vocab_size, (1, 3072), device=dev)
    pos = torch.arange(3072, 6144, dtype=torch.int32, device=dev)[None]
    clen = torch.tensor(lens, dtype=torch.int32, device=dev)
    tick_toks = torch.randint(0, cfg.vocab_size, (len(lens), 1), device=dev)
    caches = {"0": {"self": {"k": kv.pools["0"]["k"],
                             "v": kv.pools["0"]["v"],
                             "block_table": table[None].expand(
                                 cfg.n_blocks, len(lens), npg)}}}
    _profile(cfg.name, (
        ("prefill_chunk_3072_hist_3072",
         lambda: prefill_chunk_paged(params, cfg, ctx, toks, pos, kv.pools,
                                     table[3, :3072 // page].tolist(),
                                     3072), 2,
         ("K2 paged_flash_prefill", "K3 flash_attention")),
        ("decode_tick_b4",
         lambda: forward(params, cfg, ctx, tick_toks, clen[:, None],
                         "decode", caches=caches, cache_len=clen), 8,
         ("K1 paged_flash_decode",))))
    del params, kv, caches
    _free()


def phase_profile():
    """Where a prefill chunk's and a decode tick's time goes at full width,
    for each served model: kernel time by group (torch.profiler) against
    the host-clock window, whose difference is the card's idle share, and
    the same window on the host clock without the profiler."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cdsp import prefill_chunk_paged
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.models.transformer import forward
    from repro_torch.serving.cache_manager import PagedKVCache
    ctx = make_context("cuda")
    dev, page = ctx.device, 64
    lens = [512, 2048, 4096, 6144]

    _profile_attention("llama3-8b", lens, page)

    cfg = get_config("mamba2-1.3b")
    params = init_params(cfg, seed=0, device=dev)
    none = PagedKVCache(cfg, 1, page, device=dev).pools      # no attention
    first = torch.randint(0, cfg.vocab_size, (1, 3072), device=dev)
    _, _, aux = prefill_chunk_paged(
        params, cfg, ctx, first,
        torch.arange(3072, dtype=torch.int32, device=dev)[None], none, [], 0)
    toks = torch.randint(0, cfg.vocab_size, (1, 3072), device=dev)
    pos = torch.arange(3072, 6144, dtype=torch.int32, device=dev)[None]
    clen = torch.tensor(lens, dtype=torch.int32, device=dev)
    tick_toks = torch.randint(0, cfg.vocab_size, (len(lens), 1), device=dev)
    caches = {"0": {"self": {k: torch.cat([v] * len(lens), dim=1)
                             for k, v in aux["0"]["self"].items()}}}
    # the second chunk of the 6144 prompt with the first chunk's SSD state
    # and conv window handed in, and a decode tick of four rows
    _profile(cfg.name, (
        ("prefill_chunk_3072_after_3072",
         lambda: prefill_chunk_paged(params, cfg, ctx, toks, pos, none,
                                     [], 3072, aux), 2, ("K5 ssd_scan",)),
        ("decode_tick_b4",
         lambda: forward(params, cfg, ctx, tick_toks, clen[:, None],
                         "decode", caches=caches, cache_len=clen), 8, ())))
    del params, none, aux, caches
    _free()

    # Qwen1.5-MoE-A2.7B with each MoE stage under a range of its own
    # (moe_stage_ms); then ChatGLM3-6B and Nemotron-4-15B
    with _moe_ranges():
        _profile_attention("qwen2-moe-a2.7b", lens, page)
    _profile_attention("chatglm3-6b", lens, page)
    _profile_attention("nemotron-4-15b", lens, page)
    _profile_whisper()


def _profile_whisper() -> None:
    """Whisper-medium's prefill of the smoke batch (the encoder over four
    segments' 1500 frames, then the decoder's 224-token prompts with cross
    attention, and the hand-off) and one dense decode tick of the four
    rows (K4 twice a layer)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cdsp import (chunked_prefill,
                                       history_to_decode_caches)
    from repro_torch.models.sharding import make_context
    from repro_torch.models.transformer import forward
    ctx = make_context("cuda")
    dev = ctx.device
    cfg = get_config("whisper-medium")
    params = _whisper_params(cfg, 0, dev)
    frames, prompts = _whisper_inputs(cfg, 0, ctx.device)
    B, L = prompts.shape
    toks = torch.as_tensor(prompts, device=dev)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None].expand(B, L)

    def prefill():
        _, hist = chunked_prefill(params, cfg, ctx, toks, pos, [L],
                                  encoder_frames=frames)
        return history_to_decode_caches(cfg, hist, L + WHISPER_TICKS)

    caches, clen = prefill()
    tick_toks = torch.randint(0, cfg.vocab_size, (B, 1), device=dev)
    _profile(cfg.name, (
        ("prefill_b4_frames1500_prompt224", prefill, 2,
         ("K3 flash_attention",)),
        ("decode_tick_b4",
         lambda: forward(params, cfg, ctx, tick_toks, clen[:, None],
                         "decode", caches=caches, cache_len=clen), 8,
         ("K4 flash_decode",))), decode="K4 flash_decode")
    del params, caches
    _free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*",
                    choices=["device", "kernels", "serve", "serve_sp",
                             "dense", "whisper", "tokens", "profile"])
    args = ap.parse_args(argv)
    phases = args.only or ["device", "kernels", "serve", "serve_sp", "dense",
                           "whisper", "tokens"]

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    rows = phase_kernels() if "kernels" in phases else {}
    by_path = phase_serve() if "serve" in phases else {}
    if "serve_sp" in phases:
        by_path["serve_sp"] = phase_serve_sp()
    if "dense" in phases:
        by_path["dense"] = phase_dense()
    if "whisper" in phases:
        by_path["whisper"] = phase_whisper()
    if "tokens" in phases:
        phase_tokens()
    if "profile" in phases:
        phase_profile()
    table = []
    for name, (src, repl) in SOURCES.items():
        r = rows.get(name, {})
        paths = {p: c[name] for p, c in by_path.items() if name in PATHS[p]}
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": repl, "launches": sum(paths.values()),
                      "launches_by_path": paths,
                      "max_abs_err": r.get("max_abs_err"),
                      "ms": r.get("ms"), "cold_ms": r.get("cold_ms"),
                      "plain_ms": r.get("plain_ms"),
                      "bound_ms": r.get("bound_ms"),
                      "bound_by": r.get("bound_by"),
                      "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
