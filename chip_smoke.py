#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device  — the card, its power limit, the torch/CUDA versions, and the
               build of every kernel from ``src/repro_torch/kernels/csrc``;
  2. kernels — each hand-written kernel against its plain PyTorch version
               on the card, at the main path's shapes and at edge cases,
               with kernel, plain and library (SDPA) times;
  3. serve   — Llama-3-8B at full width (bf16, 32 layers, seeded weights)
               serves four requests through the port's ServingEngine; every
               kernel of the path must have launched, the first chunk,
               a history chunk and a decode tick are held to the plain
               path on the same weights, and chunk/tick device times plus
               event-clock TTFT/TBT are printed;
  4. tokens  — the same engine in fp32 at two layers (full widths): the
               kernel path and the plain path give identical greedy tokens.

The second-to-last lines are the kernel table (JSON) and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check exits nonzero before that line.  ``--only PHASE ...`` runs a
subset; with no arguments phases 1-4 run.  ``--only profile`` adds a
torch.profiler breakdown of one full-width prefill chunk and one decode
tick (kernel time by group, and the card's idle share).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
}


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
        if ev.device_type.name not in ("CUDA", "PrivateUse1"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        total += (us if us is not None
                  else getattr(ev, "self_cuda_time_total", 0.0))
    return total / 1e3


def time_ms(fn, reps: int = 10, warmup: int = 2):
    """(device ms, stream ms) per call: the card's kernel time summed by
    torch.profiler, and CUDA events around ``reps`` back-to-back calls —
    the latter includes the host's launch gaps, which exceed a small
    kernel's own time.  Where the profiler sees no device activity, the
    event time stands in for both."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return (_device_ms(prof) / reps) or stream, stream


def _times(kernel, plain, library, bms, by) -> dict:
    (k, ks), (p, ps), (lib, ls) = (time_ms(kernel), time_ms(plain, reps=3),
                                   time_ms(library))
    return dict(ms=k, plain_ms=p, library_ms=lib, bound_ms=bms, bound_by=by,
                stream_ms={"kernel": ks, "plain": ps, "library": ls})


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_b = n_bytes / PEAK_BYTES_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close_ratio(got, want, atol: float, rtol: float) -> float:
    """Worst elementwise |got - want| / (atol + rtol |want|): the check
    passes at <= 1.  A NaN anywhere gives NaN, which fails it."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


# ---------------------------------------------------------------- phase 1
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
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln][:48]
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=round(wall, 2),
         build_s_per_source={k: round(v, 2) for k, v in per.items()})
    emit(phase="device", ptxas=ptxas)
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


def _sdpa(q, k, v, mask):
    """One library call over the same K/V: q (B, Sq, H, D), k/v
    (B, Sk, KVH, D), mask (B, Sq, Sk) bool or None for plain causal."""
    import torch
    import torch.nn.functional as F
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    if mask is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m)


def phase_kernels(full_shapes: bool = True):
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, paged_flash_prefill,
        paged_flash_prefill_plain)
    from repro_torch.kernels.flash_decode import (
        POS_PAD, paged_flash_decode, paged_flash_decode_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    # o elementwise: |o - o_plain| <= atol + rtol |o_plain|.  Both sides
    # do their math in fp32 and round o once to its dtype, so they may
    # differ by one ulp of the output (2^-7 relative in bf16, under rtol),
    # while an error on the scale of |o| itself (~0.02 at the main shapes)
    # fails.  lse is fp32 on both sides.
    tol = {torch.bfloat16: dict(atol=1e-3, rtol=1e-2, lse=1e-4),
           torch.float32: dict(atol=1e-5, rtol=1e-4, lse=1e-4)}
    rows = {}
    failures = []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def o_errs(o, po, dtype):
        t = tol[dtype]
        return {"o": max_err(o, po),
                "o_ratio": close_ratio(o, po, t["atol"], t["rtol"])}

    def record(name, case, dtype, errs, main=False, times=None,
               planted=None):
        """``planted``: the plain version with V taken one key off, which
        the same check must reject (it shows the check can see a V-side
        fault at these shapes)."""
        t = tol[dtype]
        ok = (errs["o_ratio"] <= 1.0 and errs.get("lse", 0.0) <= t["lse"]
              and errs.get("pool", 0.0) == 0.0)
        extra = {}
        if planted is not None:
            extra["planted_v_one_key_off"] = {"o_ratio": planted,
                                              "rejected": planted > 1.0}
            ok = ok and planted > 1.0
        emit(phase="kernels", kernel=name, case=case,
             dtype=str(dtype).split(".")[-1], max_abs_err=errs,
             tol={"o_atol": t["atol"], "o_rtol": t["rtol"], "lse": t["lse"],
                  "pool": 0.0}, ok=ok, **extra, **(times or {}))
        if not ok:
            failures.append(f"{name}/{case}")
        if main:
            rows[name] = dict(max_abs_err=max(errs["o"], errs.get("lse", 0)),
                              **times)

    # ---- K3: flash attention over a chunk's own KV
    def k3(case, B, Sq, Sk, H, KVH, D, dtype, causal=True, window=None,
           offset=0, main=False):
        q = randn(B, Sq, H, D, dtype=dtype)
        k = randn(B, Sk, KVH, D, dtype=dtype)
        v = randn(B, Sk, KVH, D, dtype=dtype)
        qp = torch.arange(offset, offset + Sq, dtype=torch.int32, device=dev)
        kp = torch.arange(Sk, dtype=torch.int32, device=dev)
        o, l = flash_attention(q, k, v, qp, kp, causal=causal, window=window)
        po, pl = flash_attention_plain(q, k, v, qp, kp, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        errs = {**o_errs(o, po, dtype), "lse": max_err(l, pl)}
        times = planted = None
        if main:
            bad, _ = flash_attention_plain(q, k, v.roll(1, 1), qp, kp,
                                           causal=causal, window=window)
            t = tol[dtype]
            planted = close_ratio(bad, po, t["atol"], t["rtol"])
            pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
            es = torch.finfo(dtype).bits // 8
            nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KVH * D) * es \
                + B * H * Sq * 4 + (Sq + Sk) * 4
            bms, by = bound_ms(nbytes, 4 * B * H * D * pairs,
                               str(dtype).split(".")[-1])
            times = _times(
                lambda: flash_attention(q, k, v, qp, kp),
                lambda: flash_attention_plain(q, k, v, qp, kp),
                _sdpa(q, k, v, None), bms, by)
        record("flash_attention", case, dtype, errs, main, times, planted)

    # ---- K2: chunk queries against history pages
    def k2(case, B, Sq, hist, H, KVH, D, page, dtype, window=None,
           main=False):
        q = randn(B, Sq, H, D, dtype=dtype)
        S_h = max(hist) if max(hist) > 0 else page
        kd = randn(B, S_h, KVH, D, dtype=dtype)
        vd = randn(B, S_h, KVH, D, dtype=dtype)
        g2 = torch.Generator(device="cpu").manual_seed(1)
        kpool, table = _pool_from_dense(kd, page, g2)
        g2.manual_seed(1)
        vpool, _ = _pool_from_dense(vd, page, g2)
        hl = torch.tensor(hist, dtype=torch.int32, device=dev)
        qp = (hl[:, None] + torch.arange(Sq, dtype=torch.int32,
                                         device=dev)[None])
        o, l = paged_flash_prefill(q, kpool, vpool, table, hl, qp,
                                   window=window)
        po, pl = paged_flash_prefill_plain(q, kpool, vpool, table, hl, qp,
                                           window=window)
        torch.cuda.synchronize()
        errs = {**o_errs(o, po, dtype), "lse": max_err(l, pl)}
        times = planted = None
        if main:
            g2.manual_seed(1)
            vbad, _ = _pool_from_dense(vd.roll(1, 1), page, g2)
            bad, _ = paged_flash_prefill_plain(q, kpool, vbad, table, hl, qp,
                                               window=window)
            t = tol[dtype]
            planted = close_ratio(bad, po, t["atol"], t["rtol"])
            del vbad
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
        record("paged_flash_prefill", case, dtype, errs, main, times,
               planted)

    # ---- K1: paged decode with the fused append
    def k1(case, lengths, H, KVH, D, page, dtype, window=None, append=True,
           pos_pad_cols=0, pad_rows=(), main=False):
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
        kw = dict(window=window, page_pos=page_pos)
        if append:
            rows_ = torch.arange(B, device=dev)
            kw.update(k_new=randn(B, KVH, D, dtype=dtype),
                      v_new=randn(B, KVH, D, dtype=dtype),
                      append_page=table[rows_, (ln // page).long()],
                      append_slot=ln % page)
        kp2, vp2 = kpool.clone(), vpool.clone()
        planted = None
        if main:
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
        if main:
            t = tol[dtype]
            planted = close_ratio(bad[live_rows], po, t["atol"], t["rtol"])
        errs = {**o_errs(o, po, dtype), "lse": max_err(l, pl),
                "pool": float(not (torch.equal(kpool[live].nan_to_num(7.0),
                                               kp2[live].nan_to_num(7.0))
                                   and torch.equal(
                                       vpool[live].nan_to_num(7.0),
                                       vp2[live].nan_to_num(7.0))))}
        times = None
        if main:
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
        record("paged_flash_decode", case, dtype, errs, main, times,
               planted)

    bf, f32 = torch.bfloat16, torch.float32
    # main path shapes: Llama-3-8B (H 32, KVH 8, D 128), page 64; the smoke
    # trace's longest prompt (6144) runs as two 3072-token chunks, and the
    # decode batch is its four requests
    if full_shapes:
        k3("main", 1, 3072, 3072, 32, 8, 128, bf, main=True)
        k2("main", 1, 3072, [3072], 32, 8, 128, 64, bf, main=True)
        k1("main", [512, 2048, 4096, 6144], 32, 8, 128, 64, bf, main=True)
        k3("main_fp32", 1, 1024, 1024, 32, 8, 128, f32)
        k2("main_fp32", 1, 512, [1536], 32, 8, 128, 64, f32)
        k1("main_fp32", [100, 700, 1500, 3000], 32, 8, 128, 64, f32)
    for dt in (bf, f32):
        # ragged Sq and Sk, non-causal, head_dim 32, GQA groups 1/2/4
        k3("ragged_noncausal_d32_g2", 2, 100, 77, 4, 2, 32, dt, causal=False)
        k3("ragged_causal_offset_g4", 1, 70, 130, 8, 2, 128, dt, offset=60)
        k3("window_g1", 1, 129, 129, 4, 4, 32, dt, window=17)
        k3("causal_all_masked_rows", 1, 40, 40, 4, 2, 32, dt, offset=-20)
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
    from repro_torch.kernels.flash_decode import paged_flash_decode
    return {"paged_flash_decode": paged_flash_decode,
            "paged_flash_prefill": paged_flash_prefill,
            "flash_attention": flash_attention}


def _reset_counts():
    for f in _counters().values():
        f.launches = 0


def _read_counts():
    return {k: f.launches for k, f in _counters().items()}


def _serve(cfg, params, prompts, ctx, output_len, **kw):
    from repro_torch.launch.serve import serve
    return serve(cfg, params, prompts, ctx=ctx, policy=_two_chunk_policy(),
                 output_len=output_len, rate=2.0, max_batch=4, **kw)


def _hist(eng, name):
    h = eng.metrics.snapshot()["histograms"].get(name)
    return None if h is None else {k: v for k, v in h.items()
                                   if k != "buckets"}


def _replay(cfg, params, ctx, prompt, token):
    """Request ``prompt`` through the engine's own functions on a fresh
    pool: chunk 1 (K3), chunk 2 over its paged history (K2 + K3), then one
    decode tick on ``token`` (K1).  Returns the three logits rows."""
    import torch
    from repro_torch.core.cdsp import prefill_chunk_paged
    from repro_torch.models.transformer import forward
    from repro_torch.serving.cache_manager import PagedKVCache
    page = 64
    L = len(prompt)
    l0 = L // 2
    n = -(-(L + 1) // page)
    kv = PagedKVCache(cfg, n, page, device=ctx.device)
    blocks = list(range(n))
    dev = ctx.device
    toks = torch.as_tensor(prompt, device=dev)[None]
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None]
    out = []
    for off, ln in ((0, l0), (l0, L - l0)):
        lg, nc, _ = prefill_chunk_paged(
            params, cfg, ctx, toks[:, off:off + ln], pos[:, off:off + ln],
            kv.pools, blocks[:-(-off // page)], off)
        kv.write_chunk(blocks, nc, pos[:, off:off + ln])
        out.append(lg[0, 0, :cfg.vocab_size].float())
        del nc
    bt = torch.as_tensor(blocks, dtype=torch.int32, device=dev)[None]
    caches = {"0": {"self": {
        "k": kv.pools["0"]["k"], "v": kv.pools["0"]["v"],
        "block_table": bt[None].expand(cfg.n_blocks, 1, n)}}}
    clen = torch.tensor([L], dtype=torch.int32, device=dev)
    lg, _, _ = forward(params, cfg, ctx,
                       torch.tensor([[token]], device=dev), clen[:, None],
                       "decode", caches=caches, cache_len=clen)
    out.append(lg[0, 0, :cfg.vocab_size].float())
    torch.cuda.synchronize()
    return out


def phase_serve():
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.serving.simulator import summarize
    cfg = get_config("llama3-8b")
    ctx = make_context("cuda")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=ctx.device)
    torch.cuda.synchronize()
    emit(phase="serve", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         d_model=cfg.d_model, params=count_params(params),
         init_s=round(time.perf_counter() - t0, 2))
    rng = np.random.default_rng(0)
    lens = [512, 2048, 4096, 6144]
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    out_len = 16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    eng = _serve(cfg, params, prompts, ctx, out_len, max_seq=6208,
                 prefill_pool_blocks=256, host_pool_blocks=128,
                 profile_ops=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    emit(phase="serve", launches=counts, wall_s=round(wall, 2),
         peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    for name, c in counts.items():
        check(c > 0, f"kernel {name} was not launched on the main path")
    plans = {rid: r.chunk_plan for rid, r in eng.reqs.items()}
    check(any(len(p) >= 2 for p in plans.values()),
          "no request ran two or more chunks")
    for rid, toks in eng.outputs.items():
        check(len(toks) >= out_len and all(0 <= t < cfg.vocab_size
                                           for t in toks),
              f"request {rid}: bad output {toks}")
    s = summarize(eng.reqs)
    emit(phase="serve", plans={str(k): v for k, v in plans.items()},
         outputs={str(k): v for k, v in eng.outputs.items()},
         chunk_device_us=_hist(eng, "op_device_us/prefill_chunk"),
         tick_device_us=_hist(eng, "op_device_us/decode_tick"),
         scatter_device_us=_hist(eng, "op_device_us/scatter_chunk"),
         ttft_p50_s=s["ttft_p50"], ttft_p99_s=s["ttft_p99"],
         tbt_p50_s=s["tbt_p50"], clock="event")
    first_tokens = {rid: toks[0] for rid, toks in eng.outputs.items()}
    del eng
    torch.cuda.empty_cache()

    # the plain path on the same weights, replaying the longest request
    rid = len(lens) - 1
    got = _replay(cfg, params, ctx, prompts[rid], first_tokens[rid])
    check(int(torch.argmax(got[1])) == first_tokens[rid],
          "replayed prefill disagrees with the engine's first token")
    want = _replay(cfg, params, ctx.with_(impl="ref"), prompts[rid],
                   first_tokens[rid])
    # bf16 through 32 layers: the two paths round at different places, so
    # logits drift by a few hundredths; hold the worst element to 0.25 and
    # the direction of the whole row to cosine >= 0.999
    res = {}
    for name, a, b in zip(("chunk1", "chunk2_history", "decode_tick"),
                          got, want):
        err = float((a - b).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        res[name] = {"max_abs_err": err, "cos": cos,
                     "ok": err <= 0.25 and cos >= 0.999}
    emit(phase="serve", logits_vs_plain=res, tol={"max_abs_err": 0.25,
                                                  "cos": 0.999})
    check(all(r["ok"] for r in res.values()),
          "kernel-path logits disagree with the plain path")
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 4
def phase_tokens():
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              dtype="float32")
    ctx = make_context("cuda")
    params = init_params(cfg, seed=1, device=ctx.device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in (300, 1000, 2500, 4000)]
    outs = {}
    for impl in (None, "ref"):
        _reset_counts()
        eng = _serve(cfg, params, prompts, ctx.with_(impl=impl), 8,
                     max_seq=4096, prefill_pool_blocks=160,
                     host_pool_blocks=64)
        counts = _read_counts()
        outs[impl or "cuda"] = dict(eng.outputs)
        emit(phase="tokens", impl=impl or "cuda", launches=counts,
             outputs={str(k): v for k, v in eng.outputs.items()})
        if impl is None:
            check(all(c > 0 for c in counts.values()),
                  f"fp32 kernel path skipped a kernel: {counts}")
        else:
            check(not any(counts.values()),
                  f"plain path launched kernels: {counts}")
        del eng
    same = outs["cuda"] == outs["ref"]
    emit(phase="tokens", identical=same)
    check(same, "fp32 greedy tokens differ between kernel and plain paths")


# ---------------------------------------------------------- profile (opt-in)
def _kernel_groups(prof) -> dict:
    """Device time (ms) by kernel group from a torch.profiler run, and the
    largest ungrouped kernels by name."""
    groups, others = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or ev.device_type.name not in ("CUDA", "PrivateUse1"):
            continue
        name = ev.key
        g = ("K2 paged_flash_prefill" if "attn_kernel" in name
             and "true" in name else
             "K3 flash_attention" if "attn_kernel" in name else
             "K1 paged_flash_decode" if "decode_" in name else
             "gemm" if any(t in name.lower() for t in
                           ("gemm", "nvjet", "sm90_", "cutlass"))
             else "other")
        groups[g] = groups.get(g, 0.0) + us / 1e3
        if g == "other":
            others[name[:60]] = others.get(name[:60], 0.0) + us / 1e3
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    return groups, dict(top)


def phase_profile():
    """Where a prefill chunk's and a decode tick's time goes at full width:
    kernel time by group (torch.profiler) against the host-clock window,
    whose difference is the card's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cdsp import prefill_chunk_paged
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.models.transformer import forward
    from repro_torch.serving.cache_manager import PagedKVCache
    cfg = get_config("llama3-8b")
    ctx = make_context("cuda")
    params = init_params(cfg, seed=0, device=ctx.device)
    dev, page = ctx.device, 64
    lens = [512, 2048, 4096, 6144]
    npg = -(-(max(lens) + 16) // page)
    kv = PagedKVCache(cfg, len(lens) * npg, page, device=dev)
    for p in ("k", "v"):
        kv.pools["0"][p].normal_()
    table = torch.arange(len(lens) * npg, dtype=torch.int32,
                         device=dev).reshape(len(lens), npg)
    toks = torch.randint(0, cfg.vocab_size, (1, 3072), device=dev)
    pos = torch.arange(3072, 6144, dtype=torch.int32, device=dev)[None]

    def chunk():      # the second half of the 6144 prompt, 3072 of history
        return prefill_chunk_paged(params, cfg, ctx, toks, pos, kv.pools,
                                   table[3, :3072 // page].tolist(), 3072)

    clen = torch.tensor(lens, dtype=torch.int32, device=dev)
    tick_toks = torch.randint(0, cfg.vocab_size, (len(lens), 1), device=dev)
    caches = {"0": {"self": {"k": kv.pools["0"]["k"],
                             "v": kv.pools["0"]["v"],
                             "block_table": table[None].expand(
                                 cfg.n_blocks, len(lens), npg)}}}

    def tick():       # the smoke batch's decode tick (one fused step)
        return forward(params, cfg, ctx, tick_toks, clen[:, None], "decode",
                       caches=caches, cache_len=clen)

    for name, fn, reps in (("prefill_chunk_3072_hist_3072", chunk, 2),
                           ("decode_tick_b4", tick, 8)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        groups, others = _kernel_groups(prof)
        groups = {k: v / reps for k, v in groups.items()}
        busy = sum(groups.values())
        emit(phase="profile", window=name, wall_ms=wall,
             kernel_ms=groups, busy_ms=busy,
             idle_share=(1.0 - busy / wall) if busy else None,
             top_other_ms={k: v / reps for k, v in others.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*",
                    choices=["device", "kernels", "serve", "tokens",
                             "profile"])
    args = ap.parse_args(argv)
    phases = args.only or ["device", "kernels", "serve", "tokens"]

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
    counts = phase_serve() if "serve" in phases else {}
    if "tokens" in phases:
        phase_tokens()
    if "profile" in phases:
        phase_profile()
    table = []
    for name, (src, repl) in SOURCES.items():
        r = rows.get(name, {})
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": repl, "launches": counts.get(name, 0),
                      "max_abs_err": r.get("max_abs_err"),
                      "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
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
