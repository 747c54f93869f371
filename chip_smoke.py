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
               64, non-causal; K1-K3 at the served shapes of Llama-3-70B
               and Yi-9B (G 8), Phi-4-mini (G 4, 8 of 32 heads inert
               pads) and Mixtral under its window, K5 at Jamba's 256
               heads) and at edge cases, with kernel, plain and library
               times (each timed case also one call at a time with a
               cold L2, and the ``-Xptxas -v`` report of its instances),
               and K1 over one row of 131,072 keys;
  3. serve   — Llama-3-8B (bf16, 32 layers), Mamba-2-1.3B (bf16, 48
               layers), Qwen1.5-MoE-A2.7B (bf16, 24 layers, 60 routed
               experts top-4), ChatGLM3-6B (bf16, 28 layers, 32 heads over
               2 KV heads), Nemotron-4-15B (bf16, 32 layers, 48 heads
               over 8), Yi-9B (48 layers, 32 heads over 4), Phi-4-mini
               (32 layers, 24 heads padded to 32 over 8), and, cut in
               depth to fit the card (``SERVE_LAYERS``; the path's first
               line prints the cut and why), Llama-3-70B (16 of 80
               layers), Qwen2-VL-72B (16 of 80, M-RoPE, q/k/v bias),
               Mixtral-8x22B (8 of 56, 8 experts top-2 under a
               4096-token window) and Jamba-1.5-Large (its published
               layers 0-4: Mamba at 0-3 with K5 at 256 heads, MoE at 1
               and 3, attention at 4), each at full width with seeded
               weights, serve four requests through the port's
               ServingEngine; each path must launch exactly its kernels
               (K1-K3 for the attention layers, K5 for the Mamba layers),
               as many times as the trace predicts (``serve_launches``),
               the first chunk, a history chunk and a decode tick are held
               to the plain path on the same weights (and, except on
               Llama, each K1-K3 or K5 call of that replay to its plain
               version on its own inputs, with planted faults, on Mixtral
               also half the keys dropped inside its window), and
               chunk/tick device times, event-clock TTFT/TBT, weights,
               peak memory and stage seconds are printed; on the MoE
               models also the share of (token, choice) pairs that
               capacity dropped, and the routing decisions that differ
               between the replays; and each engine's host-clock share
               spent in release demotions (published pages gathered to
               the host prefix cache);
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
  3c. serve_elastic — Llama-3-8B at full width, bf16, the same trace on
               two more engines of the one card: the 4-position mesh
               engine restriped live (2 active shards before any
               prefill, 4 between the longest request's tokens 2 and 3,
               2 after its tokens 4 and 5; the log must show pages moved
               on both live resizes, no preemption, no stalled tick; each
               resize's pages and exchange time are printed), and the
               TP x SP engine on a 2 x 2 ("data" x "model") mesh, pools
               head-sharded (a quarter of the unsharded pools' bytes a
               position; K1/K3 launches exactly as predicted per chunk
               and tick).  Every step of both engines' streams is held
               by the tie rule of 3b on five paths; the longest request's
               TP x SP replay holds each K1/K3 call to its plain version
               (planted faults rejected) and its logits to the plain
               path's; device ms per chunk and tick of the four engines;
  3d. sp_families — sequence parallelism for every family on the same
               4 positions of the one card, each at full width in bf16:
               Mamba-2-1.3B's engine (chunks that divide into whole scan
               chunks a position run sp_ssd, K5 a position; the others
               one K5; launches exactly as predicted, every stream step
               held by the tie rule of 3b, each K5 call of the longest
               request's replay held to the plain scan with planted
               faults, logits within Mamba's limit), Qwen1.5-MoE-A2.7B's
               engine with expert parallelism (15 of the 60 experts a
               position; K1/K3 launches and EP islands exactly as
               predicted, routing beside the unsharded replay's, each
               K1/K3 call of the replay held to its plain version,
               logits within Qwen's limit of the mesh's plain path),
               and Llama-3-8B's dense path
               (a 6144-token prompt in zigzag order through the
               causal-skip ring, K3; the hand-off to dense caches split
               4 ways; 16 split-KV ticks, K4 a shard; launches exactly as
               predicted beside the contiguous ring's; the prefill and
               first tick replayed with each K3/K4 call held to its plain
               version, logits held to the plain path's); device ms per
               chunk and tick beside the unsharded runs', and per-call
               K3/K4/K5 times at the mesh shapes beside their bounds;
  3e. serve_tiers — (runs after 3c) the engine's KV memory tiers at
               Llama-3-8B's widths, bf16, pages of 64, through the
               ServingEngine with the serve ClusterSpec (16 prefill, 2
               decode instances): (a) a swap victim placed on the other
               instance, (b) borrowed headroom instead of a watermark
               preemption, (c) a 95-page prefix promoted from the other
               instance's pool, (d) a host prefix-cache hit after
               eviction, (e) a copy-on-write split of a shared partial
               page, (f) prefill backpressure on an 80-page pool; then (a)
               and (c) on the 4-position mesh (g).  Each mechanism must
               fire; every page move (swap-out, demotion, swap-in, host
               and peer promotion, CoW split, admission) is held bit for
               bit, destination against source pages, NaN slots
               included; K1-K3 launch exactly as each trace predicts;
               fp32 runs (two layers) give identical tokens calm,
               pressured and plain, and on the mesh; bf16 streams part
               from their calm runs only at ties; fabric counters,
               attribution, spans and the Chrome export are audited and
               every pool drains.  Each kind of page move is timed
               beside plain pinned and pageable copies of its bytes, the
               card-to-card bound and the event clock's model;
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
  6. tokens  — fp32 at two layers (full widths; Jamba its published
               layers 3-4, Mamba with MoE and the attention layer;
               Mixtral over a 5000-token prompt, past its window): each
               served model's engine gives identical greedy tokens on the
               kernel path and the plain path, Llama's 4-position mesh
               engine (also restriped live), its 2 x 2 TP x SP engine, its
               dense path and its zigzag + split-KV dense path on the mesh give
               the paged engine's tokens, Mamba-2's mesh engine (sp_ssd)
               and Qwen1.5-MoE's mesh engine with expert parallelism
               give their unsharded engines' tokens, and Whisper's
               path (two encoder and two decoder layers) gives the plain
               path's;
  7. train   — the training path (``training/``): Llama-3-8B at
               published widths cut to 4 layers (AdamW's state for all
               32 would not fit the card; the phase prints the cut), bf16,
               one 4096-token sequence a step, 8 steps of ``Trainer``, K3
               through ``FlashAttentionFn``; the whole Mamba-2-1.3B, bf16,
               2048 tokens, 4 steps under remat, K5 through ``SSDScanFn``
               (twice a layer a step); each on the kernel path and the
               plain path from one seed.  Launches exactly as predicted,
               every loss finite, the kernel path's decreasing and each
               step's within ``TRAIN_BF16_LOSS_RTOL`` of the plain
               path's; an fp32 step at full width, 2 layers and 1024
               tokens: loss within 1e-4 and every gradient leaf (each
               layer) at cosine >= 0.9999 of the plain path's, a zeroed
               gradient of one layer's K3 (K5) backward failing that
               gate.  Step ms, tokens/s, peak memory, one step split into
               forward, backward and AdamW (and the kernels and the plain
               vector-Jacobian products inside), and K3 at the train shape
               forward and forward + backward beside the plain version
               and ``scaled_dot_product_attention``; each step's ``mfu``
               (``launch.roofline.model_flops`` over its time);
  8. roofline — the reference's step shapes through
               ``launch/steps.build_step`` at published widths, each
               global batch cut to fit 80 GB (the cut printed):
               Llama-3-8B's prefill_32k (one 32768-token sequence, K3 a
               layer), decode_32k (8 sequences at position 32767 over
               34.4 GB of KV, K4 a layer) and long_500k under
               ``ring_cache`` (position 524,287 over the 4096-token
               window, K4 a layer), Mamba-2-1.3B's prefill_32k (K5 a
               layer) and long_500k (no kernel).  Each step: device ms
               (CUDA events, warm, median of 3), ``model_flops`` and the
               dry run's counted flops and bytes of the same cut shape,
               the roofline terms on the H100's peaks, the bottleneck and
               ``mfu``; the bytes the card holds before the step within
               1% of the dry run's argument bytes and the peak beside the
               dry run's; launches exactly as predicted; Llama's K3
               (first and last layer, against ``ref_blocked``) and K4
               calls (every layer) held per call in one more run, V one
               key off and half the keys dropped planted there and
               rejected; Llama's logits (and Mamba's prefill's) held to
               the plain path's (``impl="ref_blocked"`` for the 32k
               prefill, ``"ref"`` otherwise).  The whole smoke prints
               each phase's seconds before the kernel table.

The second-to-last lines are the kernel table (JSON) and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.  Any
failed check exits nonzero before that line.  ``--only PHASE ...`` runs a
subset; with no arguments phases 1-8 (3b-3e included) run.
``--only profile`` adds a torch.profiler breakdown of one full-width
prefill chunk and one decode tick of each served model and of Whisper
(kernel time by group and by aten op, on Qwen by MoE stage, and the
card's idle share); it fails where a window shows no time for a kernel
it must run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
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
         # the rest of the registry: G 8 (Yi-9B, Llama-3-70B, Qwen2-VL-72B),
         # padded heads (Phi-4-mini), a window under an MoE (Mixtral), and
         # the hybrid, whose Mamba layers scan with K5 in each chunk (its
         # ticks step the state in plain torch, as the reference's do)
         **{p: {"paged_flash_decode", "paged_flash_prefill",
                "flash_attention"}
            for p in ("serve_yi", "serve_phi", "serve_llama70b",
                      "serve_qwen2vl", "serve_mixtral")},
         "serve_jamba": {"paged_flash_decode", "paged_flash_prefill",
                         "flash_attention", "ssd_scan"},
         # the mesh path: ring steps and slabs through K3, the split-KV
         # tick through K1; K2 stays on the single-device engine
         "serve_sp": {"paged_flash_decode", "flash_attention"},
         # the same mesh restriped live 4 -> 2 -> 4 -> 2 (the exchange is
         # page copies, no kernel), and the TP x SP mesh: K3 per ring step
         # and K1 per tick on each (data, model) position's head slice
         "serve_elastic": {"paged_flash_decode", "flash_attention"},
         "serve_tp": {"paged_flash_decode", "flash_attention"},
         # sequence parallelism for every family: Mamba-2's sp_ssd (K5 a
         # position; chunks that do not divide, one K5), Qwen1.5-MoE with
         # expert parallelism (K3 ring steps, K1 a shard; EP islands are
         # no kernel), the dense path's zigzag ring (K3) and split-KV
         # ticks (K4 a shard)
         "sp_mamba": {"ssd_scan"},
         "sp_moe": {"paged_flash_decode", "flash_attention"},
         "sp_dense": {"flash_attention", "flash_decode"},
         # the memory tiers (swap, host prefix cache, the fabric, CoW,
         # backpressure): chunks and ticks as the serve phase's, page moves
         # are copies; the fabric on the mesh rings (K3) and splits ticks
         # (K1 a shard)
         "serve_tiers": {"paged_flash_decode", "paged_flash_prefill",
                         "flash_attention"},
         "sp_fabric": {"paged_flash_decode", "flash_attention"},
         "dense": {"flash_attention", "flash_decode"},
         "whisper": {"flash_attention", "flash_decode"},
         # the training path: K3 through FlashAttentionFn (Llama), K5
         # through SSDScanFn under remat (Mamba-2); the backward is the
         # plain versions' vector-Jacobian product, no kernel
         "train_llama": {"flash_attention"},
         "train_mamba": {"ssd_scan"},
         # the reference's step shapes (launch/steps.build_step): Llama's
         # prefill_32k through K3, decode_32k and long_500k through K4;
         # Mamba-2's prefill_32k through K5 (its long_500k tick is plain)
         "roofline_llama": {"flash_attention", "flash_decode"},
         "roofline_mamba": {"ssd_scan"}}
# the served attention models whose replay holds each K1-K3 call to its
# plain version (attn_call_gate)
ATTN_GATED = ("serve_moe", "serve_chatglm", "serve_nemotron", "serve_yi",
              "serve_phi", "serve_llama70b", "serve_qwen2vl", "serve_mixtral",
              "serve_jamba")
# the served paths in the order phase serve runs them (each frees its
# weights before the next starts)
SERVED = (("llama3-8b", "serve_llama"), ("mamba2-1.3b", "serve_mamba"),
          ("qwen2-moe-a2.7b", "serve_moe"), ("chatglm3-6b", "serve_chatglm"),
          ("nemotron-4-15b", "serve_nemotron"), ("yi-9b", "serve_yi"),
          ("phi4-mini-3.8b", "serve_phi"), ("llama3-70b", "serve_llama70b"),
          ("qwen2-vl-72b", "serve_qwen2vl"),
          ("mixtral-8x22b", "serve_mixtral"),
          ("jamba-1.5-large-398b", "serve_jamba"))
# served configurations whose published depth does not fit the card:
# the layers kept (at published widths).  Jamba keeps its published
# layers 0-4 (Mamba at 0-3, MoE at 1 and 3, attention at 4): a whole
# period of 8 holds four 19.3-GB MoE layers
SERVE_LAYERS = {"llama3-70b": 16, "qwen2-vl-72b": 16, "mixtral-8x22b": 8,
                "jamba-1.5-large-398b": 5}


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


def ssd_bound_ms(B, S, H, P, G, N, chunk, dtype: str, h0: bool):
    """K5's bound: every input read once and every output written once
    (the incoming state too, where there is one), and what the causal
    chunks need: C.B^T once per group, the masked product with x, the
    chunk states and the inter-chunk output per head."""
    es = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * B * S * H * P + 2 * B * S * G * N) * es \
        + B * S * H * 4 + H * 4 + (1 + h0) * B * H * P * N * 4
    flops = 0
    for c0 in range(0, S, chunk):
        lc = min(chunk, S - c0)
        tri = lc * (lc + 1) // 2
        flops += B * (2 * tri * N * G + 2 * tri * P * H
                      + 4 * lc * P * N * H)
    return bound_ms(nbytes, flops, dtype)


def ring_step_bound_ms(s: int, H: int, KVH: int, D: int, pairs: int):
    """K3's bound for one bf16 call of ``s`` queries over ``s`` keys with
    ``pairs`` visible (query, key) pairs: q, k, v, o, the LSE and both
    position arrays once each; the two products over the visible
    pairs."""
    nbytes = (2 * s * H * D + 2 * s * KVH * D) * 2 + H * s * 4 + 2 * s * 4
    return bound_ms(nbytes, 4 * H * D * pairs, "bfloat16")


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
# a call with no incoming state (a sequence-parallel position's scan):
# the faults that need none, and x of the wrong head
SSD_FAULTS_NO_H0 = {"x_one_step_off": SSD_FAULTS["x_one_step_off"],
                    "x_wrong_head": lambda x, h0: (x.roll(1, 2), h0)}


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
    for name, fault in (SSD_FAULTS if h0 is not None
                        else SSD_FAULTS_NO_H0).items():
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


# {source: {kernel instance: "spills; registers"}}, from phase_device's
# build
PTXAS = {}


def _instances(kernel: str, dtype, D: int, G: int = 0, N: int = 0) -> dict:
    """The ``-Xptxas -v`` report of the instances a call of ``kernel`` at
    ``dtype`` and head_dim (K5: head_dim P and state N) runs: K1's split
    kernel at its GQA group ``G`` and its merge kernel; K2's / K3's
    tensor-core or SIMT kernel (both TMA variants); K5's state, output
    and pass kernels."""
    bf = str(dtype).endswith("bfloat16")
    if kernel == "paged_flash_decode":
        src = "paged_decode"
        el = r"__nv_bfloat16" if bf else r"float"
        pat = (rf"decode_split_kernel<{el}, \(int\){D}, \(int\){G}, "
               rf"\(bool\)0>|decode_merge_kernel<{el}, \(int\){D}>")
    elif kernel in ("paged_flash_prefill", "flash_attention"):
        src = "flash_attention"
        paged = int(kernel == "paged_flash_prefill")
        pat = (rf"attn_{'tc' if bf else 'simt'}_kernel<\(int\){D}, "
               rf"\(bool\){paged}\b")
    else:
        src = "ssd_scan"
        pat = (rf"{'tc' if bf else 'simt'}::ssd_(state|out)(_tc)?_kernel<"
               rf"\(int\){D}, \(int\){N}>|"
               + ("tc::ssd_pass_split_kernel" if bf else
                  "simt::ssd_pass_kernel"))
    return {k: v for k, v in PTXAS.get(src, {}).items()
            if re.search(pat, k)}


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
    PTXAS.update(ptxas)
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
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import padded_head_indices
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
           offset=0, kv_offset=0, perm=None, zero_heads=(), main=False,
           timed=False):
        """``perm``: "within" shuffles key positions inside each 64-key
        tile, "across" over all keys (K/V rows move with them), so a tile's
        positions are neither sorted nor its index's.  ``zero_heads``:
        query heads set to zero (inert padded heads).  ``main``: the kernel
        table's row; ``timed`` (implied by ``main``): times and a planted
        fault."""
        timed = timed or main
        q = randn(B, Sq, H, D, dtype=dtype)
        q[:, :, list(zero_heads)] = 0
        k = randn(B, Sk, KVH, D, dtype=dtype)
        v = randn(B, Sk, KVH, D, dtype=dtype)
        qp = torch.arange(offset, offset + Sq, dtype=torch.int32, device=dev)
        kp = torch.arange(kv_offset, kv_offset + Sk, dtype=torch.int32,
                          device=dev)
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
            mask = None
            if window is not None:
                # the (query, key) pairs the window leaves
                d = qp[:, None] - kp[None]
                mask = ((d >= 0) & (d < window))[None].expand(B, Sq, Sk)
                pairs = int(mask[0].sum())
            es = torch.finfo(dtype).bits // 8
            nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KVH * D) * es \
                + B * H * Sq * 4 + (Sq + Sk) * 4
            bms, by = bound_ms(nbytes, 4 * B * H * D * pairs,
                               str(dtype).split(".")[-1])
            kw = dict(causal=causal, window=window)
            times = _times(
                lambda: flash_attention(q, k, v, qp, kp, **kw),
                lambda: flash_attention_plain(q, k, v, qp, kp, **kw),
                _sdpa(q, k, v, mask, causal), bms, by)
            times.update(_cold_times(
                lambda: flash_attention(q, k, v, qp, kp, **kw)))
            times["ptxas"] = _instances("flash_attention", dtype, D)
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
           zero_heads=(), main=False, fault=False, timed=False,
           nan_tail=False):
        """``fault`` (implied by ``main`` and ``timed``): the check must
        also reject a planted fault (V one key off) at this case's shape;
        ``timed`` (implied by ``main``): times; ``nan_tail``: NaN in the
        slots past each row's history; ``zero_heads``: as k3's."""
        timed = timed or main
        q = randn(B, Sq, H, D, dtype=dtype)
        q[:, :, list(zero_heads)] = 0
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
            kg = kd[:, :max(hist)]
            vg = vd[:, :max(hist)]
            kpos = torch.arange(max(hist), device=dev)[None, None]
            mask = (kpos < hl[:, None, None]).expand(B, Sq, max(hist))
            if window is not None:
                mask = mask & (qp[:, :, None] - kpos < window)
            # the visible (query, key) pairs: Sq * sum(hist) without a
            # window
            es = torch.finfo(dtype).bits // 8
            nbytes = 2 * B * Sq * H * D * es + 2 * sum(hist) * KVH * D * es \
                + B * H * Sq * 4
            bms, by = bound_ms(nbytes, 4 * H * D * int(mask.sum()),
                               str(dtype).split(".")[-1])
            kw = dict(window=window)
            times = _times(
                lambda: paged_flash_prefill(q, kpool, vpool, table, hl, qp,
                                            **kw),
                lambda: paged_flash_prefill_plain(q, kpool, vpool, table, hl,
                                                  qp, **kw),
                _sdpa(q, kg, vg, mask), bms, by)
            times.update(_cold_times(
                lambda: paged_flash_prefill(q, kpool, vpool, table, hl, qp,
                                            **kw)))
            times["ptxas"] = _instances("paged_flash_prefill", dtype, D)
        record("paged_flash_prefill", case, dtype, errs, main, times,
               planted)

    # ---- K1: paged decode with the fused append
    def k1(case, lengths, H, KVH, D, page, dtype, window=None, append=True,
           pos_pad_cols=0, pad_rows=(), zero_heads=(), main=False,
           timed=False, nan_tail=False):
        """``main``: the kernel table's row; ``timed`` (implied by
        ``main``): times (warm and cold L2) and a planted fault;
        ``nan_tail``: NaN in the slots at and past each row's length (the
        append slot included, which the call writes first);
        ``zero_heads``: as k3's."""
        timed = timed or main
        B = len(lengths)
        S = max(max(lengths) + 1, 1)
        q = randn(B, H, D, dtype=dtype)
        q[:, list(zero_heads)] = 0
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
            Smax = max(lengths) + 1
            kg = kd[:, :Smax]
            vg = vd[:, :Smax]
            kpos = torch.arange(Smax, device=dev)[None, None]
            mask = kpos < (ln + 1)[:, None, None]
            es = torch.finfo(dtype).bits // 8
            att = sum(lengths) + (B if append else 0)
            if window is not None:
                # only the keys inside each row's window are read
                mask = mask & (kpos > ln[:, None, None] - window)
                att = int(mask.sum())
            nbytes = 2 * B * H * D * es + 2 * att * KVH * D * es \
                + B * H * 4 + (2 * B * KVH * D * es if append else 0)
            bms, by = bound_ms(nbytes, 4 * H * D * att,
                               str(dtype).split(".")[-1])
            times = _times(
                lambda: paged_flash_decode(q, kpool, vpool, table, ln, **kw),
                lambda: paged_flash_decode_plain(q, kp2, vp2, table, ln,
                                                 **kw),
                _sdpa(q[:, None], kg, vg, mask), bms, by)
            times.update(_cold_times(
                lambda: paged_flash_decode(q, kpool, vpool, table, ln, **kw)))
            times["ptxas"] = _instances("paged_flash_decode", dtype, D,
                                        H // KVH)
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
           main=False, timed=False):
        """``main``: the kernel table's row; ``timed`` (implied by
        ``main``): times (warm and cold L2) and the planted faults."""
        timed = timed or main
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
        if timed:
            planted = ssd_planted(x, dt, A, Bm, Cm, hz, chunk)
            bms, by = ssd_bound_ms(B, S, H, P, G, N, chunk,
                                   str(dtype).split(".")[-1], h0)
            times = _times(
                lambda: ssd_scan(x, dt, A, Bm, Cm, h0=hz, chunk=chunk),
                lambda: ssd_scan_plain(x, dt, A, Bm, Cm, h0=hz,
                                       chunk=chunk),
                None, bms, by)
            times.update(_cold_times(
                lambda: ssd_scan(x, dt, A, Bm, Cm, h0=hz, chunk=chunk)))
            times["ptxas"] = _instances("ssd_scan", dtype, P, N=N)
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
        # the instances the rest of the registry serves (phase serve's
        # serve_yi ... serve_jamba), each at the served shapes: K3 the
        # longest prompt's second chunk (3072 queries over their own keys
        # at positions 3072-6143), K2 that chunk over its 3072 history
        # tokens, K1 the decode batch.  G 8 at head_dim 128 (Llama-3-70B's
        # 64 / 8 heads, Yi-9B's 32 / 4), G 4 with 8 of 32 query heads
        # inert zero pads (Phi-4-mini: 24 heads padded over 8 KV heads,
        # every fourth head of a group a pad), and Mixtral's 48 / 8 under
        # its 4096-token window (K2's later queries and K1's 4096- and
        # 6144-token rows lose keys to it); K5 at Jamba's 256 heads over
        # a 3072-token chunk
        phi = get_config("phi4-mini-3.8b")
        for who, H, KVH, kw in (
                ("llama70b_g8", 64, 8, {}), ("yi_g8", 32, 4, {}),
                ("phi_g4_padded", 32, 8,
                 {"zero_heads": padded_head_indices(phi)}),
                ("mixtral_window4096_served", 48, 8, {"window": 4096})):
            k3(who, 1, 3072, 3072, H, KVH, 128, bf, offset=3072,
               kv_offset=3072, timed=True, **kw)
            k2(who, 1, 3072, [3072], H, KVH, 128, 64, bf, timed=True, **kw)
            k1(who, [512, 2048, 4096, 6144], H, KVH, 128, 64, bf, timed=True,
               **kw)
        k5("jamba_h256", 1, 3072, 256, 64, 1, 128, 256, bf, timed=True)
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
def _two_chunk_policy(parallel: bool = False):
    from repro_torch.core.chunk_planner import Allocation, Chunk
    from repro_torch.core.latency_model import table1_model
    from repro_torch.launch.serve import SPEC
    from repro_torch.serving.simulator import Policy

    class TwoChunkPolicy(Policy):
        """Every prompt of two or more tokens runs as two chunks, the
        second over the first's paged history at SP 2.  The tetris plan
        keeps each smoke prompt to one chunk (the cluster is idle), which
        would leave the history kernel unexercised.  ``parallel`` gives
        request ``rid`` its own instance pair (the reference tests'
        ParallelTwoChunkPolicy), so requests prefill concurrently."""
        name = "parallel_two_chunk" if parallel else "two_chunk"

        def plan(self, req, pool, now):
            L = req.prompt_len
            lo = (2 * req.rid) % (self.spec.n_prefill - 1) if parallel \
                else 0
            l0 = L // 2
            t_q = pool[lo]
            t0 = t_q + self.model.latency(1, 0, l0)
            t1 = max(t0, pool[lo + 1]) + self.model.latency(2, l0, L - l0)
            return Allocation([Chunk(l0, (lo,), t_q, t0),
                               Chunk(L - l0, (lo, lo + 1), t0, t1)])

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


@contextlib.contextmanager
def demote_clock():
    """Host-clock seconds the engines built inside the block spend in
    release demotions (``ServingEngine._demote_blocks``: the gather of a
    finished request's published pages to the host prefix cache), the
    card synchronised around each: yields {"calls", "pages", "s"}."""
    import torch
    from repro_torch.serving.engine import ServingEngine
    fn = ServingEngine._demote_blocks
    out = {"calls": 0, "pages": 0, "s": 0.0}

    def timed(self, did, dying):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(self, did, dying)
        torch.cuda.synchronize()
        out["calls"] += 1
        out["pages"] += len(dying)
        out["s"] += time.perf_counter() - t0

    ServingEngine._demote_blocks = timed
    try:
        yield out
    finally:
        ServingEngine._demote_blocks = fn


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
    # on a mesh context the pool stripes over the live stripe's SP
    # positions (``ctx.active_pool_shards`` of them): logical page j on
    # shard j % act, as the engine's BlockManager allocates; on a TP x SP
    # context the pool is head-sharded too, as the engine builds it
    n_sh = ctx.pool_shards("prefill")
    act = ctx.active_shards("prefill")
    pages = -(-(L + len(tokens)) // page)
    bps = -(-pages // act)
    n = bps * n_sh
    kv = PagedKVCache(cfg, n, page, kv_shards=n_sh,
                      mesh=ctx.mesh if n_sh > 1 else None,
                      shard_axis=ctx.pool_axis("prefill"),
                      head_axis=(ctx.pool_head_axis(cfg.n_kv_heads)
                                 if n_sh > 1 else None), device=ctx.device)
    blocks = [(j % act) * bps + j // act for j in range(bps * act)]
    dev = ctx.device
    toks = torch.as_tensor(prompt, device=dev)[None]
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None]
    if cfg.rope_type == "mrope":
        # (3, B, S): a text prompt's temporal, height and width rows agree,
        # as the engine builds them
        pos = pos[None].expand(3, 1, L)
    out = []
    aux = None
    for off, ln in ((0, l0), (l0, L - l0)):
        lg, nc, aux = prefill_chunk_paged(
            params, cfg, ctx, toks[:, off:off + ln], pos[..., off:off + ln],
            kv.pools, blocks[:-(-off // page)], off, aux)
        kv.write_chunk(blocks, nc, pos[..., off:off + ln], active=act)
        out.append(lg[0, 0, :cfg.vocab_size].float())
        del nc
    bt = np.asarray(blocks, np.int32)[None]
    if n_sh > 1:
        bt = shard_block_table(bt, act, bps, n_slots=n_sh)
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
        dpos = (clen[None, :, None].expand(3, 1, 1)
                if cfg.rope_type == "mrope" else clen[:, None])
        lg, _, caches = forward(params, cfg, ctx,
                                torch.tensor([[token]], device=dev),
                                dpos, "decode", caches=caches,
                                cache_len=clen)
        out.append(lg[0, 0, :cfg.vocab_size].float())
    torch.cuda.synchronize()
    return out


def ssd_call_gate(run, n_layers: int, per: int = 1):
    """Run ``run()``, two chunks of an attention-free Mamba model of
    ``n_layers`` layers on the kernel path, with each K5 call also held to
    the plain scan on the same inputs (that layer's activations) under
    K5's check; the kernel's outputs go on unchanged.  ``per`` is the K5
    calls a layer makes in a chunk (a sequence-parallel chunk: one a
    position).  The second chunk's first call of the first layer and
    last call of the last layer keep their inputs, and the check must
    reject each of ``SSD_FAULTS`` planted there (``SSD_FAULTS_NO_H0``
    for a call without an incoming state).  Returns (``run()``'s result,
    a report whose ``ok`` says whether all calls passed and all planted
    faults were rejected)."""
    import statistics
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    kernel = ops.ssd_scan
    c = per * n_layers
    keep = {c: "layer0_chunk2",
            2 * c - 1: f"layer{n_layers - 1}_chunk2"}
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
        report[f"worst_{k}"] = {"ratio": ratios[i][k],
                                "layer": i // per % n_layers,
                                "position": i % per, "chunk": i // c + 1}
        report[f"median_{k}"] = statistics.median(r[k] for r in ratios)
    report["planted"] = {name: ssd_planted(*ins)
                         for name, ins in kept.items()}
    report["ok"] = (len(ratios) == 2 * c
                    and all(r["y"] <= 1.0 and r["h"] <= 1.0 for r in ratios)
                    and len(kept) == len(keep)
                    and all(v > 1.0 for p in report["planted"].values()
                            for v in p.values()))
    return out, report


def paged_gate_plan(n_layers: int):
    """(calls, keep) of ``attn_call_gate`` for a served model's replay (two
    chunks, then a decode tick) with ``n_layers`` attention layers: K3
    runs once a layer in each chunk (the second chunk's calls follow the
    first's), K2 in the second chunk, K1 in the tick; the calls kept for
    planted faults are those of the first and the last attention
    layer (one call where there is one layer)."""
    def ends(first, last):
        return tuple(sorted({first, last}))
    return ({"flash_attention": 2 * n_layers, "paged_flash_prefill": n_layers,
             "paged_flash_decode": n_layers},
            {"flash_attention": ends(n_layers, 2 * n_layers - 1),
             "paged_flash_prefill": ends(0, n_layers - 1),
             "paged_flash_decode": ends(0, n_layers - 1)})


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


def _v_one_key_off(name, ins):
    """V one key off: in a dense chunk along the keys, in a pool along
    each page's slots."""
    return (*ins[:2], ins[2].roll(1, 1), *ins[3:])


def _half_keys_dropped(name, ins):
    """The second half of the keys dropped: K3's keys themselves, each K4
    or K1 row's length and K2's history length halved (the keys dropped
    are the latest, which a window keeps)."""
    if name == "flash_attention":
        q, k, v, q_pos, kv_pos = ins[:5]
        n = k.shape[1] // 2
        return (q, k[:, :n], v[:, :n], q_pos, kv_pos[..., :n], *ins[5:])
    if name == "flash_decode":
        return (*ins[:3], ins[3] // 2, *ins[4:])
    if name in ("paged_flash_prefill", "paged_flash_decode"):
        return (*ins[:4], ins[4] // 2, *ins[5:])
    raise ValueError(f"no half-keys fault for {name}")


def _half_keys_visible(name, ins, window) -> int:
    """How many of the keys ``_half_keys_dropped`` drops from a call of
    ``name`` (batch row 0) some query of the call sees under ``window``:
    a fault whose keys all lie outside every query's window would hide
    behind the mask."""
    import torch
    if name == "flash_attention":
        q_pos, kv_pos = ins[3].reshape(-1), ins[4].reshape(-1)
        dropped = kv_pos[kv_pos.shape[0] // 2:].long()
    elif name == "paged_flash_prefill":
        n = int(ins[4].reshape(-1)[0])
        q_pos = ins[5].reshape(-1)
        dropped = torch.arange(n // 2, n, device=q_pos.device)
    elif name == "paged_flash_decode":
        # the query is the appended token, at the row's length
        n = int(ins[4].reshape(-1)[0])
        q_pos = torch.tensor([n])
        dropped = torch.arange(n // 2, n)
    else:
        raise ValueError(f"no half-keys count for {name}")
    lo, hi = int(q_pos.min()), int(q_pos.max())
    seen = dropped <= hi
    if window is not None:
        seen &= dropped > lo - window
    return int(seen.sum())


# faults planted in an attention call's inputs (as its plain version
# takes them), which attn_call_gate's check must reject
ATTN_FAULTS = {"v_one_key_off": _v_one_key_off,
               "half_keys_dropped": _half_keys_dropped}


def attn_call_gate(run, want_calls: dict, keep: dict, *, held=None,
                   plain_fns=None, faults=("v_one_key_off",), window=None):
    """Run ``run()``, a kernel-path replay of a bf16 attention model, with
    each call of the kernels named in ``want_calls`` (K1-K4) also held to
    its plain version on the same inputs (that layer's activations, the
    pools as the call found them) under ``KERNEL_TOL``'s bf16 check; the
    kernels' outputs go on unchanged.  ``want_calls`` says how many calls
    of each kernel the replay makes; the calls whose indices ``keep``
    lists keep their inputs, and the check must reject each of ``faults``
    (``ATTN_FAULTS``) planted there (``paged_gate_plan``,
    ``whisper_gate_plan``).  ``held`` ({kernel: call indices}) holds only
    those calls (default: every call); ``plain_fns`` ({kernel: fn})
    replaces a kernel's plain version (one whose scores would not fit).
    Under a sliding ``window`` each kept call must also drop keys that
    some query sees where ``half_keys_dropped`` is planted
    (``_half_keys_visible``), or the fault would hide behind the mask.
    Returns (``run()``'s result, a report whose ``ok`` says whether every
    held call passed and every planted fault was rejected)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_plain, paged_flash_prefill_plain)
    from repro_torch.kernels.flash_decode import (flash_decode_plain,
                                                  paged_flash_decode_plain)
    plains = {"flash_attention": flash_attention_plain,
              "paged_flash_prefill": paged_flash_prefill_plain,
              "paged_flash_decode": paged_flash_decode_plain,
              "flash_decode": flash_decode_plain}
    plains = {n: (plain_fns or {}).get(n, plains[n]) for n in want_calls}
    kernels = {n: getattr(ops, n) for n in plains}
    calls = {n: [] for n in plains}
    seen = {n: 0 for n in plains}
    kept = {}
    tol = KERNEL_TOL["bfloat16"]

    def ratios(got, want):
        return {"o": close_ratio(got[0], want[0], tol["atol"], tol["rtol"]),
                "lse": max_err(got[1], want[1]) / tol["lse"]}

    def recorder(name):
        def call(*args, **kw):
            i = seen[name]
            seen[name] += 1
            if held is not None and i not in held[name]:
                return kernels[name](*args, **kw)
            ins = args
            if name == "paged_flash_decode":
                # the fused append writes the pools in place: the plain
                # version gets copies taken before the kernel's call
                ins = (args[0], args[1].clone(), args[2].clone()) + args[3:]
            got = kernels[name](*args, **kw)
            want = plains[name](*ins, **kw)
            if i in keep[name]:
                kept[(name, i)] = (ins, kw, want)
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
        report[name] = {"calls": seen[name], "held": len(rs)}
        for k in ("o", "lse") if rs else ():
            i = max(range(len(rs)), key=lambda i: rs[i][k])
            report[name][f"worst_{k}"] = {"ratio": rs[i][k], "call": i}
    planted = {}
    for fault in faults:
        planted[fault] = {}
        for (name, i), (ins, kw, want) in kept.items():
            bad = plains[name](*ATTN_FAULTS[fault](name, ins), **kw)
            planted[fault][f"{name}_call{i}"] = close_ratio(
                bad[0], want[0], tol["atol"], tol["rtol"])
            del bad
        report[f"planted_{fault}"] = planted[fault]
    visible = {}
    if "half_keys_dropped" in faults and window is not None:
        visible = {f"{name}_call{i}": _half_keys_visible(name, ins, window)
                   for (name, i), (ins, _, _) in kept.items()}
        report["half_keys_visible"] = {"window": window, **visible}
    n_held = {n: want_calls[n] if held is None else len(held[n])
              for n in want_calls}
    report["ok"] = (
        seen == want_calls
        and {n: len(rs) for n, rs in calls.items()} == n_held
        and all(r[k] <= 1.0 for rs in calls.values() for r in rs
                for k in r)
        and all(len(p) == sum(len(v) for v in keep.values())
                and all(v > 1.0 for v in p.values())
                for p in planted.values())
        and all(v > 0 for v in visible.values()))
    return out, report


@contextlib.contextmanager
def moe_routes():
    """Record the routing of every MoE layer call made inside the block:
    yields a list that gains, per call, {"T": real tokens, "C": capacity,
    "top_idx": (n, g, k), "keep": (n, g, k)} (tensors left on the
    device), in call order: layer by layer within a forward, forward by
    forward.  The layer's results are not touched."""
    import torch
    from repro_torch.models import moe
    route, group = moe._route, moe._group_tokens
    calls = []

    def group_rec(x, g):
        xt, T, pad = group(x, g)
        calls.append({"T": T})
        return xt, T, pad

    def route_rec(xt, router_w, m, E, C):
        r = route(xt, router_w, m, E, C)
        call = calls[-1]
        if "top_idx" in call:
            # an expert-parallel island routes its token parts one by one
            r_all = {k: torch.cat([call[k], r[k].to(call[k].device)])
                     for k in ("top_idx", "keep")}
        else:
            r_all = r
        call.update(C=C, top_idx=r_all["top_idx"], keep=r_all["keep"])
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
# held per call instead (attn_call_gate).  Mixtral-8x22B's and
# Jamba-1.5-Large's are 0.6 and 0.95 for the same reason, measured the
# same way (--arch; seeds 0 and 1, the smoke's two longest requests):
# Mixtral's right paths (kernel, and plain with attention one ulp off)
# read down to cosine 0.9831 and up to max |err| 0.347, its planted
# faults (K2's partial left out, every router choice shifted) at most
# 0.598 and at least 1.660 in their worst row; Jamba's right path reads
# down to 0.9731 and up to 0.354 (K5's rounding in layers 0 and 2 moves
# the router choices of layers 1 and 3), its shifted routers at most
# 0.860 and at least 0.867.  Jamba's one attention layer is its last,
# so the logits barely see a fault there (K2 left out: 0.9996); its
# K1-K3 and K5 calls are held per call (both gates, nested)
LOGIT_TOL = {"llama3-8b": {"max_abs_err": 0.25, "cos": 0.999},
             "mamba2-1.3b": {"max_abs_err": 0.25, "cos": 0.998},
             "qwen2-moe-a2.7b": {"max_abs_err": 0.25, "cos": 0.98},
             "chatglm3-6b": {"max_abs_err": 0.25, "cos": 0.999},
             "nemotron-4-15b": {"max_abs_err": 0.25, "cos": 0.999},
             "whisper-medium": {"max_abs_err": 0.25, "cos": 0.999},
             "yi-9b": {"max_abs_err": 0.25, "cos": 0.999},
             "phi4-mini-3.8b": {"max_abs_err": 0.25, "cos": 0.999},
             "llama3-70b": {"max_abs_err": 0.25, "cos": 0.999},
             "qwen2-vl-72b": {"max_abs_err": 0.25, "cos": 0.999},
             "mixtral-8x22b": {"max_abs_err": 0.6, "cos": 0.95},
             "jamba-1.5-large-398b": {"max_abs_err": 0.6, "cos": 0.95}}


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


def cut_depth(cfg, n_layers: int, first: int = 0):
    """``cfg`` at published widths with ``n_layers`` layers.  A pattern
    longer than the cut (Jamba's period of 8) keeps its entries
    ``first .. first + n_layers - 1``, those published layers, as one
    block."""
    if first == 0 and n_layers % len(cfg.pattern) == 0:
        return dataclasses.replace(cfg, n_layers=n_layers)
    pattern = cfg.pattern[first:first + n_layers]
    check(len(pattern) == n_layers, f"{cfg.name}: no cut of {n_layers} "
          f"layers from layer {first}")
    return dataclasses.replace(cfg, n_layers=n_layers, pattern=pattern)


def weight_gb(cfg) -> float:
    """GB of ``cfg``'s parameter tree in its dtype, counted from the
    shapes (nothing allocated), embeddings included."""
    import torch
    from repro_torch.models.params import param_shapes

    def n(t):
        return (sum(n(v) for v in t.values()) if isinstance(t, dict)
                else math.prod(t))
    es = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    return n(param_shapes(cfg)) * es / 1e9


def served_config(arch: str):
    """(the configuration phase serve runs, its depth cut or None): a cut
    keeps ``SERVE_LAYERS[arch]`` layers at published widths and says
    why."""
    from repro_torch.configs.registry import get_config
    full = get_config(arch)
    if arch not in SERVE_LAYERS:
        return full, None
    cfg = cut_depth(full, SERVE_LAYERS[arch])
    why = (f"{full.n_layers} layers are {weight_gb(full):.1f} GB of "
           f"{full.dtype} weights, beyond the card's 80 GB; "
           f"{cfg.n_layers} are {weight_gb(cfg):.1f} GB, beside the pools "
           "and the plain replay, within the smoke's time")
    if cfg.pattern != full.pattern:
        why += (f"; one whole period of {len(full.pattern)} layers is "
                f"{weight_gb(cut_depth(full, len(full.pattern))):.1f} GB, "
                f"so the published layers 0-{cfg.n_layers - 1} run: "
                + ", ".join(f"{i} {s.mixer}+{s.ffn}"
                            for i, s in enumerate(cfg.pattern)))
    return cfg, {"layers": cfg.n_layers, "of": full.n_layers, "why": why}


def count_layers(cfg, **spec) -> int:
    """Layers of ``cfg`` whose ``LayerSpec`` fields have the values given
    (``mixer="attn"``, ``ffn="moe"``, ...)."""
    return cfg.n_blocks * sum(all(getattr(s, k) == v for k, v in spec.items())
                              for s in cfg.pattern)


def serve_launches(cfg) -> dict:
    """The kernel launches the smoke trace makes on ``cfg``'s engine: each
    of the four requests' two chunks runs K3 once an attention layer, the
    second chunk K2 too, and K5 once a Mamba layer; the 64 decode ticks
    (16 a request: the arrivals 0.5 s apart do not overlap on the event
    clock) run K1 once an attention layer (Mamba layers step the state
    in plain torch)."""
    a, m = count_layers(cfg, mixer="attn"), count_layers(cfg, mixer="mamba")
    return {"paged_flash_decode": 64 * a, "paged_flash_prefill": 4 * a,
            "flash_attention": 8 * a, "flash_decode": 0, "ssd_scan": 8 * m}


def _serve_path(arch: str, path: str) -> dict:
    """Serve the smoke trace on ``arch`` at full width (and published or
    cut depth, ``served_config``); returns the launch counts of the
    run."""
    import numpy as np
    import torch
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.sharding import make_context
    from repro_torch.serving.simulator import summarize
    cfg, cut = served_config(arch)
    ctx = make_context("cuda")
    # what an earlier path left on the card (its weights must be gone)
    before = torch.cuda.memory_allocated() / 2**30
    t_path = t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=ctx.device)
    torch.cuda.synchronize()
    emit(phase="serve", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         depth_cut=cut, d_model=cfg.d_model, params=count_params(params),
         weights_gib=round(torch.cuda.memory_allocated() / 2**30 - before, 2),
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
    with moe_routes() as routes, demote_clock() as demote:
        eng = _serve(cfg, params, prompts, ctx, out_len, max_seq=6208,
                     prefill_pool_blocks=256, host_pool_blocks=128,
                     profile_ops=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    emit(phase="serve", model=cfg.name, launches=counts,
         wall_s=round(wall, 2),
         peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2),
         release_demotions={**demote, "share_of_wall": demote["s"] / wall})
    _check_launches(counts, path)
    want_counts = serve_launches(cfg)
    check(counts == want_counts, f"{cfg.name}: launches {counts}, the trace "
          f"predicts {want_counts}")
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
    n_moe = count_layers(cfg, ffn="moe")
    if n_moe:
        # what capacity did to the served tokens (decode ticks route their
        # rows as one group of 4: capacity 1 per expert)
        emit(phase="serve", model=cfg.name,
             routing=routing_summary(routes, n_moe, 4))
    del routes
    first_tokens = {rid: toks[0] for rid, toks in eng.outputs.items()}
    del eng
    _free()

    # the plain path on the same weights, replaying the longest request;
    # each K1-K3 call (ATTN_GATED) and each K5 call of the kernel-path
    # replay is also held to its plain version on its own inputs, the two
    # gates nested on the hybrid so that each sees every call of its own
    rid = len(lens) - 1
    n_mamba = count_layers(cfg, mixer="mamba")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gates = {}

    def replay():
        return _replay(cfg, params, ctx, prompts[rid], [first_tokens[rid]])

    def ssd_gated():
        out, gates["ssd_calls"] = ssd_call_gate(replay, n_mamba)
        return out

    run = ssd_gated if n_mamba else replay
    faults = ("v_one_key_off",) + (("half_keys_dropped",)
                                   if cfg.sliding_window else ())
    with moe_routes() as got_routes:
        if path in ATTN_GATED:
            got, gates["attention_calls"] = attn_call_gate(
                run, *paged_gate_plan(count_layers(cfg, mixer="attn")),
                faults=faults, window=cfg.sliding_window)
        else:
            got = run()
    t_gated = time.perf_counter() - t0
    if "ssd_calls" in gates:
        emit(phase="serve", model=cfg.name, ssd_calls=gates["ssd_calls"],
             tol={k: SSD_TOL[k] for k in ("bfloat16", "h_final")})
        check(gates["ssd_calls"]["ok"], f"{cfg.name}: a K5 call of the "
              "replay disagrees with the plain scan, or a planted fault "
              f"passed: {gates['ssd_calls']}")
    if "attention_calls" in gates:
        emit(phase="serve", model=cfg.name,
             attention_calls=gates["attention_calls"],
             tol=KERNEL_TOL["bfloat16"])
        check(gates["attention_calls"]["ok"], f"{cfg.name}: a K1-K3 call "
              "of the replay disagrees with its plain version, or a planted "
              f"fault passed: {gates['attention_calls']}")
    check(int(torch.argmax(got[1])) == first_tokens[rid],
          f"{cfg.name}: replayed prefill disagrees with the engine's first "
          "token")
    t0 = time.perf_counter()
    with moe_routes() as want_routes:
        want = _replay(cfg, params, ctx.with_(impl="ref"), prompts[rid],
                       [first_tokens[rid]])
    t_plain = time.perf_counter() - t0
    if n_moe:
        # bf16 attention differs between the paths by an ulp here and
        # there, which can flip a near-tied router choice
        emit(phase="serve", model=cfg.name, routing_vs_plain=routing_diff(
            got_routes, want_routes, n_moe,
            ("chunk1", "chunk2_history", "decode_tick")))
    del got_routes, want_routes
    emit(phase="serve", model=cfg.name, stage_s={
        "serve": round(wall, 2), "gated_replay": round(t_gated, 2),
        "plain_replay": round(t_plain, 2),
        "path": round(time.perf_counter() - t_path, 2)},
        replay_peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2))
    _logits_vs_plain("serve", ("chunk1", "chunk2_history", "decode_tick"),
                     got, want, LOGIT_TOL[arch])
    del params
    _free()
    return counts


# seconds for the six paths served last (Yi-9B ... Jamba-1.5-Large),
# weight init included: they take 45-48 s on an H100 80GB HBM3 at 700 W
# (PERF.md §6)
SERVE_NEW_BUDGET_S = 90


def phase_serve() -> dict:
    """Every path of ``SERVED`` in turn (each frees its weights before
    the next starts); prints each path's seconds and the six paths'
    against their budget.  Returns the launch counts by path."""
    new = [p for _, p in SERVED[5:]]
    emit(phase="serve", paths=[p for _, p in SERVED], new_paths=new,
         new_budget_s=SERVE_NEW_BUDGET_S)
    out, seconds = {}, {}
    for arch, path in SERVED:
        t0 = time.time()
        out[path] = _serve_path(arch, path)
        seconds[path] = round(time.time() - t0, 2)
    emit(phase="serve", seconds_by_path=seconds,
         new_paths_s=round(sum(seconds[p] for p in new), 2),
         new_budget_s=SERVE_NEW_BUDGET_S)
    return out


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
        bms, by = ring_step_bound_ms(s, H, KVH, D, pairs)
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


def _stream_ties(cfg, params, ctxs: dict, prompts, want: dict, got: dict,
                 replays=None):
    """Teacher-force each request's whole stream in ``want`` on every path
    (``ctxs``: name -> context) and hold every step: each path's argmax
    must be ``want``'s token, or the step a tie, every path scoring the two
    tokens within TIE_TOL.  ``got`` maps each engine held to ``want`` to
    its streams: the step where an engine's stream first parts from
    ``want``'s is held to the same rule with that engine's token; after
    it the engine runs on another prefix, and the paths' rows on
    ``want``'s prefix are what is checked.  Returns per request: the
    steps checked, each engine's first parting, each step and token other
    than ``want``'s (each path's score gap, ``tie``, the engines whose
    token it was), and the largest row difference between each two
    paths.  ``replays``, where given, keeps each replay by prompt and
    stream for the next request or call."""
    import itertools
    import numpy as np
    import torch
    out = {}
    for rid, a in want.items():
        part = {e: next((i for i, (x, y) in enumerate(zip(a, g[rid]))
                         if x != y), None) for e, g in got.items()}
        rows = None
        if replays is not None:
            key = (np.asarray(prompts[rid]).tobytes(), tuple(a))
            rows = replays.get(key)
        if rows is None:
            rows = {n: torch.stack(_replay(cfg, params, c, prompts[rid],
                                           a[:-1])[1:])
                    for n, c in ctxs.items()}
            if replays is not None:
                replays[key] = rows
        others = []
        for t, tok in enumerate(a):
            alt = {int(r[t].argmax()) for r in rows.values()}
            alt |= {got[e][rid][t] for e, i in part.items() if i == t}
            for g in sorted(alt - {tok}):
                gaps = {n: abs(float(r[t, tok] - r[t, g]))
                        for n, r in rows.items()}
                others.append({
                    "step": t, "tokens": [tok, g],
                    "argmax": [n for n, r in rows.items()
                               if int(r[t].argmax()) == g],
                    "engines": [e for e, i in part.items()
                                if i == t and got[e][rid][t] == g],
                    "gaps": gaps, "tie": max(gaps.values()) <= TIE_TOL})
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
                        prompts, flat["outputs"], {"sharded": sh["outputs"]})
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


# --------------------------------------------------- phase 3c: serve_elastic
TP = 2            # TP positions of the TP x SP engine ("model" axis)


def _tp_context(impl=None):
    """The TP x SP engine's context: a "data" x "model" mesh of SP // TP
    x TP positions, every one on the one card; the pools stripe over
    "data" and, Llama's 8 KV heads dividing "model", shard their KV
    heads over it."""
    from repro_torch.launch.mesh import make_context, make_mesh
    return make_context(make_mesh((SP // TP, TP), ("data", "model"),
                                  device="cuda"), "serve_paged", impl=impl)


def tp_launches(n_layers: int) -> dict:
    """Launches per step on the TP x SP mesh, from the shapes: each TP
    index rings its query heads over its SP column of SP // TP
    positions, so a first chunk makes (SP // TP)^2 K3 calls a layer and
    TP index, a history chunk twice that (own KV, then the slab), and a
    tick one K1 call a (data, model) position and layer."""
    sp = SP // TP
    return {"chunk1_K3": TP * sp * sp * n_layers,
            "chunk2_K3": 2 * TP * sp * sp * n_layers,
            "tick_K1": sp * TP * n_layers}


def tp_gate_plan(n_layers: int):
    """(calls, keep) of ``attn_call_gate`` for the TP x SP replay (two
    chunks, then a tick), in the order (TP index, ring step, position).
    Kept for planted faults: the history chunk's first own and slab calls
    (layer 0, TP index 0) and its last two (the last layer, TP index 1),
    and the tick's first and last calls."""
    per = tp_launches(n_layers)
    c1, c2, k1 = per["chunk1_K3"], per["chunk2_K3"], per["tick_K1"]
    return ({"flash_attention": c1 + c2, "paged_flash_decode": k1},
            {"flash_attention": (c1, c1 + 1, c1 + c2 - 2, c1 + c2 - 1),
             "paged_flash_decode": (0, k1 - 1)})


def _serve_resized(cfg, params, prompts, ctx, output_len, restripes, **kw):
    """``_serve``'s trace on an engine asked for ``restripes`` ((width,
    time) pairs, ``request_restripe``) before it serves.  Each pool's
    ``PagedKVCache.restripe`` is timed between CUDA events.  Returns the
    drained engine and, per resize, the pages moved and the device ms of
    its exchanges (one per pool)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import SPEC
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    eng = ServingEngine(cfg, params, SPEC, _two_chunk_policy(), ctx=ctx,
                        max_batch=4, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, arrival=i / 2.0, prompt_len=len(p),
                           output_len=output_len), np.asarray(p, np.int32))
    for n, at in restripes:
        eng.request_restripe(n, at=at)
    calls = []

    def timed(kv):
        move = kv.restripe

        def restripe(pairs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            move(pairs)
            end.record()
            end.synchronize()
            calls.append((len(pairs), start.elapsed_time(end)))
        return restripe

    pools = [kv for _, kv in eng._pool_pairs()]
    for kv in pools:
        kv.restripe = timed(kv)
    eng.serve()
    k = len(pools)
    return eng, [{"pages": sum(m for m, _ in calls[i:i + k]),
                  "ms": sum(t for _, t in calls[i:i + k])}
                 for i in range(0, len(calls), k)]


def _pool_bytes(kv) -> int:
    """Bytes one mesh position holds of ``kv``'s pools (every layer, K and
    V), its scratch page aside: position 0's tensor of each leaf."""
    total = 0
    for ent in kv.pools.values():
        for leaf in ent.values():
            while isinstance(leaf, list):
                leaf = leaf[0]
            total += leaf[:, :-1].nbytes
    return total


def phase_serve_elastic() -> dict:
    """Llama-3-8B at full width, bf16, the serve phase's trace, on two
    more engines of the one card.  Restripe: the 4-position mesh engine
    narrowed to 2 active shards before any prefill, widened 2 -> 4
    between the longest request's tokens 2 and 3 and narrowed 4 -> 2
    between its tokens 4 and 5 (times from the unresized run); its
    restripe log must show widths [2, 4, 2], pages moved on both live
    resizes, no preemption and no stalled tick.  TP x SP: the engine on a
    2 x 2 ("data" x "model") mesh, pools head-sharded; per position a
    quarter of the unsharded pools' bytes, and exactly the predicted K1
    and K3 launches per chunk and tick.  Every step of every stream of
    both is held by ``_stream_ties`` against the unsharded engine's
    streams; the longest request's TP x SP replay holds each K1/K3 call
    to its plain version (planted faults rejected), and its logits to the
    plain path's.  Returns the launch counts of both runs."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.sharding import make_context
    cfg = get_config("llama3-8b")
    ctx = make_context("cuda")
    sp_ctx, tp_ctx = _sp_context(), _tp_context()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=ctx.device)
    torch.cuda.synchronize()
    emit(phase="serve_elastic", model=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, params=count_params(params),
         mesh_sp=repr(sp_ctx.mesh), mesh_tp=repr(tp_ctx.mesh),
         init_s=round(time.perf_counter() - t0, 2))
    rng = np.random.default_rng(0)
    lens = [512, 2048, 4096, 6144]
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    out_len = 16
    kw = dict(max_seq=6208, prefill_pool_blocks=256, host_pool_blocks=128,
              profile_ops=True)
    last = len(lens) - 1
    runs = {}
    resizes = None
    for name, c in (("unsharded", ctx), ("sharded", sp_ctx),
                    ("restriped", sp_ctx), ("tp", tp_ctx)):
        _free()
        _reset_counts()
        t0 = time.perf_counter()
        if name == "restriped":
            tt = runs["sharded"]["token_times"]
            eng, resizes = _serve_resized(
                cfg, params, prompts, c, out_len,
                [(2, None), (4, 0.5 * (tt[2] + tt[3])),
                 (2, 0.5 * (tt[4] + tt[5]))], **kw)
        else:
            eng = _serve(cfg, params, prompts, c, out_len, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = {
            "launches": _read_counts(), "outputs": dict(eng.outputs),
            "plans": {rid: r.chunk_plan for rid, r in eng.reqs.items()},
            "token_times": list(eng.reqs[last].token_times),
            "pool_bytes": {"prefill": _pool_bytes(eng.pkv),
                           "decode": _pool_bytes(eng.dstates[0].kv)},
            "kv_head_shards": eng.pkv.kv_head_shards,
            "ticks": (_hist(eng, "op_device_us/decode_tick")
                      or {"count": 0})["count"],
            "chunk_device_us": _hist(eng, "op_device_us/prefill_chunk"),
            "tick_device_us": _hist(eng, "op_device_us/decode_tick"),
            "restripe_log": list(eng.restripe_log),
            "restripe_device_us": _hist(
                eng, "op_device_us/restripe_all_to_all"),
            "preempt_log": list(eng.preempt_log),
            "stall_ticks": eng.stall_ticks}
        emit(phase="serve_elastic", model=cfg.name, engine=name,
             wall_s=round(wall, 2),
             **{k: v for k, v in runs[name].items()
                if k not in ("outputs", "plans", "token_times",
                             "preempt_log")},
             outputs={str(k): v for k, v in eng.outputs.items()})
        del eng
    flat, el, tp = runs["unsharded"], runs["restriped"], runs["tp"]
    for name in ("restriped", "tp"):
        check(all(len(p) == 2 for p in runs[name]["plans"].values()),
              f"serve_elastic {name}: every request must run two chunks")

    # restripe: the log, and each live resize's pages and exchange time
    log = el["restripe_log"]
    page_bytes = (2 * cfg.n_layers * 64 * cfg.n_kv_heads * cfg.head_dim_
                  * 2)
    for r, e in zip(resizes, log):
        r.update(n_old=e["n_old"], n_new=e["n_new"],
                 migrated_blocks=e["migrated_blocks"],
                 bytes=r["pages"] * page_bytes,
                 bound_ms=bound_ms(2 * r["pages"] * page_bytes, 0,
                                   "bfloat16")[0])
    emit(phase="serve_elastic", model=cfg.name, resizes=resizes,
         page_bytes=page_bytes, restripe_device_us=el["restripe_device_us"])
    _check_launches(el["launches"], "serve_elastic")
    check([e["n_new"] for e in log] == [2, 4, 2],
          f"serve_elastic: restripe log {log}")
    check(log[0]["migrated_blocks"] == 0 and log[1]["migrated_blocks"] > 0
          and log[2]["migrated_blocks"] > 0,
          f"serve_elastic: the live resizes must move pages: {log}")
    check(not el["preempt_log"] and el["stall_ticks"] == 0,
          f"serve_elastic: a resize preempted or stalled: "
          f"{el['preempt_log']}, {el['stall_ticks']} stalled ticks")
    check([r["pages"] for r in resizes] == [e["migrated_blocks"]
                                           for e in log],
          f"serve_elastic: pages moved {resizes} against the log {log}")

    # TP x SP: head-sharded pools, a quarter of the bytes a position, and
    # the launches the shapes predict
    per = tp_launches(cfg.n_layers)
    n_req = len(lens)
    want = {"flash_attention": n_req * (per["chunk1_K3"]
                                        + per["chunk2_K3"]),
            "paged_flash_decode": tp["ticks"] * per["tick_K1"]}
    emit(phase="serve_elastic", model=cfg.name, engine="tp",
         launches_per_step=per, launches_predicted=want,
         pool_bytes_per_position=tp["pool_bytes"],
         pool_bytes_unsharded=flat["pool_bytes"])
    _check_launches(tp["launches"], "serve_tp")
    check(tp["kv_head_shards"] == TP,
          f"serve_elastic: pools head-sharded {tp['kv_head_shards']} ways")
    check(all(tp["launches"][k] == v for k, v in want.items()),
          f"serve_elastic: TP x SP launches {tp['launches']}, predicted "
          f"{want}")
    check(all(4 * tp["pool_bytes"][k] == flat["pool_bytes"][k]
              for k in ("prefill", "decode")),
          f"serve_elastic: a position's pool bytes {tp['pool_bytes']} are "
          f"not a quarter of the unsharded {flat['pool_bytes']}")
    emit(phase="serve_elastic", model=cfg.name, device_ms={
        f"{op}_mean": {k: r[f"{op}_device_us"]["mean"] / 1e3
                       for k, r in runs.items() if r[f"{op}_device_us"]}
        for op in ("chunk", "tick")},
        tokens_identical={n: {str(r): runs[n]["outputs"][r] == t
                              for r, t in flat["outputs"].items()}
                          for n in ("sharded", "restriped", "tp")})

    # every step of every stream of both engines, on every path
    ties = _stream_ties(
        cfg, params, {"unsharded": ctx, "sharded": sp_ctx,
                      "narrowed": sp_ctx.with_(active_pool_shards=2),
                      "tp": tp_ctx, "plain": ctx.with_(impl="ref")},
        prompts, flat["outputs"], {"restriped": el["outputs"],
                                   "tp": tp["outputs"]})
    emit(phase="serve_elastic", model=cfg.name, stream_ties=ties,
         tie_tol=TIE_TOL, steps_checked=sum(r["steps"] for r in ties.values()))
    check(all(o["tie"] for r in ties.values() for o in r["others"]),
          "serve_elastic: a path's greedy token differs from the unsharded "
          f"engine's at a step that is no tie: {ties}")

    # the longest request's TP x SP replay: each K1/K3 call held to its
    # plain version, and the logits to the plain (unsharded) path's
    first = flat["outputs"][last][0]
    _free()
    got, gate = attn_call_gate(
        lambda: _replay(cfg, params, tp_ctx, prompts[last], [first]),
        *tp_gate_plan(cfg.n_layers))
    L = lens[last]
    pages = -(-(L + 1) // 64)
    emit(phase="serve_elastic", model=cfg.name, engine="tp",
         attention_calls=gate, tol=KERNEL_TOL["bfloat16"],
         shard_shapes={"K3_queries": L // 2 // (SP // TP),
                       "K3_heads": cfg.padded_heads // TP,
                       "K3_kv_heads": cfg.n_kv_heads // TP,
                       "K1_table_cols": -(-pages // (SP // TP))})
    check(gate["ok"], "serve_elastic: a K1/K3 call of the TP x SP replay "
          f"disagrees with its plain version, or a planted fault passed: "
          f"{gate}")
    check(int(torch.argmax(got[1])) == first,
          "serve_elastic: the TP x SP replay disagrees with the engine's "
          "first token")
    want = _replay(cfg, params, ctx.with_(impl="ref"), prompts[last],
                   [first])
    _logits_vs_plain("serve_elastic", ("chunk1", "chunk2_history",
                                       "decode_tick"),
                     got, want, LOGIT_TOL["llama3-8b"])
    del got, want, params
    _free()
    return {"serve_elastic": el["launches"], "serve_tp": tp["launches"]}


# --------------------------------------------------- phase 3e: serve_tiers
# The engine's KV memory tiers at Llama-3-8B's widths on the card: swap to
# host memory, the host prefix cache, the KV fabric across the two decode
# instances (placed swap-in, borrowed headroom, peer prefix promotion),
# copy-on-write sharing and prefill backpressure, through the ServingEngine
# with ``launch/serve.py``'s ClusterSpec; then the fabric on the
# 4-position mesh.  Page moves are copies, not kernels.
TIER_PAGE = 64
# (a)'s swap model: the reference test's (tests/test_kv_fabric.py:58,
# 1e8 B/s for 64-token prompts) at 64 times the bandwidth for prompts of
# 64 times the tokens, so a victim's swap takes what it takes there (85
# ms of event time).  At 1e8 B/s a 4096-token swap takes 5.45 s, both
# instances are idle by then, and the fabric resumes on the origin.
TIER_PCIE_BW = 6.4e9
# the kinds of device -> host page reads, by the engine function that
# makes them (a ``_gather`` or ``_store`` suffix names one half of a
# two-step move)
READ_KINDS = {"_swap_out": "swap_out", "_demote_blocks": "demote",
              "peer_pages": "peer_promote_gather"}


def _bits(t):
    """A tensor's bytes as integers, where it lies and as it is strided:
    NaNs compare too."""
    import torch
    return t.detach().view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                            8: torch.int64}[t.element_size()])


def _kv_pages(kv, blocks, host: bool = True) -> dict:
    """Pages ``blocks`` of a ``PagedKVCache`` (unsharded, or striped: a
    list of per-shard pools), read by plain indexing, on the host through
    a page-locked buffer (or, ``host=False``, where the pool lies):
    {layer: {"k"/"v": (nb, n, page, KVH, D)}}."""
    import torch
    out = {}
    for layer, ent in kv.pools.items():
        out[layer] = {}
        for part, pool in ent.items():
            if isinstance(pool, list):
                pages = []
                for b in blocks:
                    s, loc = kv._local(int(b))
                    pages.append(pool[s][:, loc])
                t = torch.stack(pages, 1)
            else:
                t = pool[:, torch.as_tensor([int(b) for b in blocks],
                                            device=pool.device)]
            if host and t.device.type != "cpu":
                t = torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=True).copy_(t)
            out[layer][part] = t
    return out


def _host_pages(src, blocks) -> dict:
    """Pages of a host-side source (``HostKVPool``, a peer gather) as
    views, a list of one page each: nothing is copied."""
    return {layer: {part: [pool[:, int(b)] for b in blocks]
                    for part, pool in ent.items()}
            for layer, ent in src.pools.items()}


def _pages_of(x) -> list:
    """A part's pages: a list of pages, or the pages of a
    (nb, n, page, KVH, D) tensor."""
    return x if isinstance(x, list) else list(x.unbind(1))


def _same_pages(got: dict, want: dict) -> bool:
    """Page by page, as integers."""
    import torch
    if got.keys() != want.keys():
        return False
    for layer in want:
        if got[layer].keys() != want[layer].keys():
            return False
        for part in want[layer]:
            g, w = _pages_of(got[layer][part]), _pages_of(want[layer][part])
            if len(g) != len(w) or not all(
                    torch.equal(_bits(a), _bits(b)) for a, b in zip(g, w)):
                return False
    return True


def _nbytes(pages: dict) -> int:
    return sum(t.numel() * t.element_size()
               for ent in pages.values() for x in ent.values()
               for t in _pages_of(x))


class PageAudit:
    """Wraps the page ops of one engine's pools and host tier (instance
    attributes; nothing in the package changes): every swap-out, demotion,
    swap-in, host promotion, peer promotion, CoW split and admission copy
    is held bit for bit, destination pages against source pages, and
    timed — device ms between CUDA events, host ms on the host clock
    around a synchronised call.  ``moves`` maps a kind to its list of
    {pages, bytes, device_ms, host_ms}; ``faults`` lists the moves whose
    bytes differ; ``audit_s`` is the host time of the audit's own reads
    and compares."""

    def __init__(self, eng):
        self.eng = eng
        self.cuda = eng.ctx.device.type == "cuda"
        self.moves: dict = {}
        self.faults: list = []
        self.audit_s = 0.0
        for kv in [eng.pkv] + [d.kv for d in eng.dstates]:
            kv.read_blocks = self._read(kv, kv.read_blocks)
            kv.copy_from = self._copy(kv, kv.copy_from)
            kv.copy_within = self._within(kv, kv.copy_within)
        if eng.host is not None:
            eng.host.store = self._store(eng.host, eng.host.store)

    @staticmethod
    def _caller() -> str:
        return sys._getframe(2).f_code.co_name

    def _timed(self, fn):
        """(result, device ms, host ms) of ``fn()``."""
        import torch
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn()
            return out, None, (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b), (time.perf_counter() - t0) * 1e3

    def _held(self, fn):
        """``fn()``, its host time added to ``audit_s``."""
        t0 = time.perf_counter()
        out = fn()
        self.audit_s += time.perf_counter() - t0
        return out

    def _note(self, kind, pages, nbytes, dev, host, ok, what):
        rec = self.moves.setdefault(kind, [])
        rec.append({"pages": pages, "bytes": nbytes, "device_ms": dev,
                    "host_ms": host})
        if not ok:
            self.faults.append({"kind": kind, "what": what,
                                "pages": pages})

    def _read(self, kv, fn):
        def read_blocks(blocks):
            kind = READ_KINDS[self._caller()]
            blocks = [int(b) for b in blocks]
            out, dev, host = self._timed(lambda: fn(blocks))
            self._note(kind, len(blocks), _nbytes(out), dev, host,
                       self._held(lambda: _same_pages(
                           out, _kv_pages(kv, blocks))),
                       "device pages -> host staging")
            return out
        return read_blocks

    def _store(self, pool, fn):
        def store(blocks, data):
            caller = self._caller()
            kind = "swap_out" if caller == "_swap_out" else "demote"
            blocks = [int(b) for b in blocks]
            _, _, host = self._timed(lambda: fn(blocks, data))
            self._note(kind + "_store", len(blocks), _nbytes(data), None,
                       host, self._held(lambda: _same_pages(
                           _host_pages(pool, blocks), data)),
                       "host staging -> host pool")
        return store

    def _copy(self, kv, fn):
        from repro_torch.serving.cache_manager import PagedKVCache

        def copy_from(src, src_blocks, dst_blocks):
            caller = self._caller()
            src_list = [int(b) for b in src_blocks]
            dst_list = [int(b) for b in dst_blocks]
            if not src_list:
                return fn(src, src_list, dst_list)
            device_src = isinstance(src, PagedKVCache)
            if caller == "_on_swap_in_done":
                kind = "swap_in"
            elif device_src:
                kind = "admission"
            elif src is self.eng.host:
                kind = "host_promote"
            else:
                kind = "peer_promote"
            # pages from a device pool compare on the device
            want = self._held(lambda: _kv_pages(src, src_list, host=False)
                              if device_src else _host_pages(src, src_list))
            _, dev, host = self._timed(lambda: fn(src, src_list, dst_list))
            self._note(kind, len(dst_list), _nbytes(want), dev, host,
                       self._held(lambda: _same_pages(
                           _kv_pages(kv, dst_list, host=not device_src),
                           want)),
                       f"{type(src).__name__} pages -> device pool")
        return copy_from

    def _within(self, kv, fn):
        def copy_within(src_block, dst_block):
            want = self._held(lambda: _kv_pages(kv, [src_block],
                                                host=False))
            _, dev, host = self._timed(lambda: fn(src_block, dst_block))
            self._note("cow_split", 1, _nbytes(want), dev, host,
                       self._held(lambda: _same_pages(
                           _kv_pages(kv, [dst_block], host=False), want)),
                       "copy-on-write page")
        return copy_within

    def counts(self) -> dict:
        """{kind: [moves, pages]} (the times go into ``_move_table``)."""
        return {kind: [len(rec), sum(r["pages"] for r in rec)]
                for kind, rec in self.moves.items()}


def _nan_pools(eng) -> None:
    """Unused page slots of the engine's device pools hold NaN, so a read
    that leaks past a mask, or a move that misses a slot, shows.  Kernel
    path only: the plain path is the reference's oracle (``kernels/
    ref.py``), which weights masked slots by zero as the Pallas kernels
    do and so needs the zero-filled pools the engine makes (ROADMAP
    Queue 3)."""
    for kv in [eng.pkv] + [d.kv for d in eng.dstates]:
        for ent in kv.pools.values():
            for pool in ent.values():
                for t in (pool if isinstance(pool, list) else [pool]):
                    t.fill_(float("nan"))


class _ChunkCalls:
    """Counts the engine's chunk forwards, and those over a history (K2's
    calls: a second chunk, or a first chunk after a promoted prefix)."""

    def __enter__(self):
        import repro_torch.serving.engine as em
        self.mod, self.fn = em, em.prefill_chunk_paged
        self.calls, self.history = 0, 0

        def counted(params, cfg, ctx, toks, pos, pools, hist_bt, off, aux):
            self.calls += 1
            self.history += off > 0
            return self.fn(params, cfg, ctx, toks, pos, pools, hist_bt,
                           off, aux)
        em.prefill_chunk_paged = counted
        return self

    def __exit__(self, *exc):
        self.mod.prefill_chunk_paged = self.fn


def _tier_engine(cfg, params, ctx, jobs, preempt=(), audit=False,
                 **kw):
    """One ServingEngine over ``jobs`` [(rid, arrival, prompt, out)], its
    device pools NaN-filled on the kernel path; ``audit`` wraps its page
    ops.  Returns (engine, PageAudit or None, launches, predicted
    launches, wall s of building the engine and of serving)."""
    import torch
    from repro_torch.launch.serve import SPEC
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, SPEC, _two_chunk_policy(parallel=True),
                        ctx=ctx, block_size=TIER_PAGE, **kw)
    if ctx.device.type == "cuda" and ctx.impl != "ref":
        _nan_pools(eng)
    pa = PageAudit(eng) if audit else None
    for rid, arrival, prompt, out in jobs:
        eng.submit(Request(rid=rid, arrival=arrival, prompt_len=len(prompt),
                           output_len=out), prompt)
    for rid, at in preempt:
        eng.preempt(rid, at=at)
    _reset_counts()
    t1 = time.perf_counter()
    with _ChunkCalls() as cc:
        eng.serve()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    wall = {"build": t1 - t0, "serve": time.perf_counter() - t1}
    chunks = sum(1 for e in eng.tracer.events if e.kind == "chunk")
    ticks = sum(1 for e in eng.tracer.events if e.kind == "tick")
    check(chunks == cc.calls, f"serve_tiers: {cc.calls} chunk forwards "
          f"where the trace has {chunks} chunks")
    L = cfg.n_layers
    n = ctx.pool_shards("prefill")
    if n > 1:
        # the mesh: each position rings over the others' K/V (a chunk over
        # a history twice: its own K/V, then the striped history slabs);
        # each tick is one split-KV K1 a shard
        want = {"flash_attention": L * n * n * (chunks + cc.history),
                "paged_flash_decode": L * n * ticks}
    else:
        want = {"flash_attention": L * chunks,
                "paged_flash_prefill": L * cc.history,
                "paged_flash_decode": L * ticks}
    return eng, pa, _read_counts(), want, wall


def _drained(eng) -> dict:
    """What must be back at its baseline when a trace ends."""
    return {"free_pages": all(d.blocks.n_free == d.blocks.total_blocks
                              for d in eng.dstates)
            and eng.pblocks.n_free == eng.pblocks.total_blocks,
            "swapped_now": eng.swap_stats["swapped_now"],
            "leases": eng.fabric.leased_blocks + sum(
                len(d.blocks.leases) for d in eng.dstates),
            "swap_gauges": sum(i.swapped_tokens + i.swap_in_flight
                               for i in eng.decodes)}


def _telemetry_audit(eng) -> dict:
    """test_telemetry.py's audits on a served engine: the fabric counters
    against swap_stats, the per-instance breakdown and the tracer's
    entries; attribution against each TTFT, bit for bit; closed spans; a
    Chrome export that parses with one event per tracer event."""
    from repro_torch.serving.telemetry import attribution_total
    ss = eng.swap_stats
    out = {"attribution_bit_equal": all(
        attribution_total(eng.tracer.attribution(
            r.rid, r.arrival, r.prefill_done)) == r.ttft
        for r in eng.reqs.values()),
        "open_spans": len(eng.tracer.open_spans())}
    doc = json.loads(json.dumps(eng.export_trace()))
    xi = [e for e in doc["traceEvents"] if e["ph"] in ("X", "i")]
    out["chrome_events"] = [len(xi), len(eng.tracer.events)]
    if "fabric" in ss:
        fab, pi = ss["fabric"], ss["per_instance"]
        reg = eng.metrics.snapshot()["counters"]
        ic = sum(d.transfers.stats["ic_placed_bytes"]
                 + d.transfers.stats["ic_peer_promote_bytes"]
                 + d.transfers.stats["ic_lease_bytes"] for d in eng.dstates)
        out["fabric_counters_agree"] = (
            all(reg.get(f"fabric/{k}", 0) == fab[k]
                for k in ("swap_in_placed", "swap_in_pinned", "leases_out",
                          "leases_recalled", "peer_promotions",
                          "interconnect_bytes"))
            and len(eng.tracer.entries("swap_place")) == fab["swap_in_placed"]
            and fab["swap_in_placed"] + fab["swap_in_pinned"]
            == ss["swap_ins"]
            and sum(p["swap_ins"] for p in pi.values()) == ss["swap_ins"]
            and sum(p["swap_outs"] for p in pi.values()) == ss["swap_outs"]
            and sum(p["swap_in_placed"] for p in pi.values())
            == fab["swap_in_placed"]
            and ic == fab["interconnect_bytes"]
            and eng.metrics.gauge("fabric/leases_active").value == 0)
    return out


def _tier_scenarios(vocab: int, seed: int = 7):
    """The seven traces (a)-(f) and their calm twins, as
    name -> dict(jobs, kw, calm_kw, calm_jobs, preempt_from, fires)."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def prompt(L):
        return rng.integers(0, vocab, L).astype(np.int32)

    out = {}
    # (a) placed swap: one resident an instance; rid 0 is swap-preempted
    # between its tokens 5 and 6 while rid 2 waits for its slot, and
    # resumes on the instance rid 1 has emptied
    out["placed_swap"] = dict(
        jobs=[(i, i * 0.005, prompt(4096), o)
              for i, o in enumerate((24, 18, 16))],
        kw=dict(max_batch=1, max_seq=4160, preempt_policy="swap",
                offload=TIER_PCIE_BW),
        preempt_at=(0, 5))
    # (b) borrow: 16 pages an instance; rids 0 and 2 (5 pages each) share
    # instance 0 and, growing into their sixth pages, dip under the 0.3
    # watermark floor (5 pages) while instance 1 (rid 1, 7 pages) has
    # room; with the fabric off this trace preempts 7 times.  The calm
    # run has no watermark
    out["borrow"] = dict(
        jobs=[(0, 0.0, prompt(300), 32), (1, 0.02, prompt(400), 8),
              (2, 0.04, prompt(300), 32)],
        kw=dict(max_batch=2, max_seq=512, preempt_watermark=0.3),
        calm_kw=dict(max_batch=2, max_seq=512))
    # (c) peer promotion: a 6144-token base decoding 60 tokens; its twin
    # shares the first 6080 tokens (95 pages) and arrives at the base's
    # token 2, landing on the other instance
    base = prompt(6144)
    twin = base.copy()
    twin[6080:] = prompt(64)
    out["peer_promote"] = dict(
        jobs=[(0, 0.0, base, 60), (1, None, twin, 8)],
        kw=dict(max_batch=2, max_seq=6208), calm_kw=dict(
            max_batch=2, max_seq=6208, fabric="off"),
        arrive_at=(1, 0, 2))
    # (d) host prefix hit: a 4096-token request finishes and its pages
    # demote; the twin arrives after it left the card
    a = prompt(4096)
    out["host_prefix"] = dict(
        jobs=[(0, 0.0, a, 6), (1, None, a.copy(), 6)],
        kw=dict(max_batch=2, max_seq=4160), arrive_after=(1, 0, 0.5))
    # (e) CoW: B's prompt is A's first 4000 tokens, ending inside a page,
    # so B's first token lands in a page it shares with A
    a = prompt(4096)
    out["cow"] = dict(
        jobs=[(0, 0.0, a, 12), (1, 0.01, a[:4000].copy(), 8)],
        kw=dict(max_batch=2, max_seq=4160),
        calm_kw=dict(max_batch=2, max_seq=4160, prefix_sharing=False))
    # (f) backpressure: 80 prefill pages for three concurrent 4096-token
    # prefills (64 pages each)
    out["backpressure"] = dict(
        jobs=[(i, i * 0.001, prompt(4096), 4) for i in range(3)],
        kw=dict(max_batch=4, max_seq=4160, prefill_pool_blocks=80),
        calm_kw=dict(max_batch=4, max_seq=4160))
    return out


# the fp32 runs' depth: tokens exact on two layers at full widths, as in
# phase tokens (the event clock, and so every scenario's timing, does not
# depend on the depth or the dtype)
TIER_FP32_LAYERS = 2


def _fires(name, eng, pa=None) -> dict:
    """Scenario ``name``'s mechanism on a served engine: its counters and
    whether it fired."""
    ss = eng.swap_stats
    fab = ss.get("fabric", {})
    if name == "placed_swap":
        c = {"swap_in_placed": fab.get("swap_in_placed", 0),
             "rid0_instance": eng.reqs[0].decode_instance}
        ok = c["swap_in_placed"] >= 1 and c["rid0_instance"] == 1
    elif name == "borrow":
        c = {k: fab.get(k, 0) for k in ("leases_out", "leases_recalled")}
        c["preemptions"] = len(eng.preempt_log)
        ok = (c["leases_out"] >= 1 and c["preemptions"] == 0
              and c["leases_recalled"] == c["leases_out"])
    elif name == "peer_promote":
        twin = eng.reqs[1]
        c = {k: fab.get(k, 0) for k in ("peer_promotions",
                                        "peer_promoted_blocks")}
        c["twin_planned_tokens"] = sum(ch[0] for ch in twin.chunk_plan)
        c["instances"] = [eng.reqs[0].decode_instance,
                          twin.decode_instance]
        ok = (c["peer_promotions"] >= 1 and c["peer_promoted_blocks"] >= 90
              and c["twin_planned_tokens"]
              <= twin.prompt_len - 90 * TIER_PAGE
              and c["instances"][0] != c["instances"][1])
    elif name == "host_prefix":
        c = {k: ss[k] for k in ("demotions", "demote_gathers",
                                "host_prefix_hits")}
        c["twin_decodes_as_a"] = eng.outputs[0] == eng.outputs[1]
        if pa is not None:
            c["largest_demote_gather"] = max(
                (r["pages"] for r in pa.moves.get("demote", [])), default=0)
        ok = (c["demotions"] >= 63 and c["host_prefix_hits"] >= 63
              and c.get("largest_demote_gather", 63) >= 63)
    elif name == "cow":
        c = {"cow": sum(d.blocks.stats["cow"] for d in eng.dstates),
             "shared": sum(d.blocks.stats["shared"] for d in eng.dstates)}
        ok = c["cow"] >= 1
    else:
        c = {"restarts": sum(r.preemptions for r in eng.reqs.values()),
             "done": sum(r.done is not None for r in eng.reqs.values())}
        ok = c["restarts"] >= 1 and c["done"] == len(eng.reqs)
    return {"ok": ok, **c}


def _tier_times(sc, run) -> tuple:
    """Resolve a scenario's timed parts against calm runs of ``run``
    (jobs, engine kw -> engine): arrivals keyed to another request's
    token or finish, and the manual preemption between two tokens.
    Returns (jobs, preempt, the calm run where resolving took one, else
    None)."""
    jobs = list(sc["jobs"])
    if "arrive_at" in sc or "arrive_after" in sc:
        rid, of, x = sc.get("arrive_at") or sc["arrive_after"]
        probe = run([j for j in jobs if j[0] == of],
                    sc.get("calm_kw", sc["kw"]))
        r = probe.reqs[of]
        t = r.token_times[x] if "arrive_at" in sc else r.done + x
        jobs = [(i, t if i == rid else a, p, o) for i, a, p, o in jobs]
    preempt, calm = (), None
    if "preempt_at" in sc:
        rid, k = sc["preempt_at"]
        calm = run(jobs, sc.get("calm_kw", sc["kw"]))
        tt = calm.reqs[rid].token_times
        preempt = ((rid, 0.5 * (tt[k] + tt[k + 1])),)
    return jobs, preempt, calm


def _engine_kw(kw: dict, side_lm) -> dict:
    kw = {"prefill_pool_blocks": 256, **kw}
    bw = kw.pop("offload", None)
    if bw is not None:
        kw["offload_model"] = side_lm.HostOffloadModel(pcie_bw=bw, base=0.0)
    return kw


def _copy_yardsticks(sizes) -> dict:
    """Host-clock ms (median of three) of moving each of ``sizes`` bytes
    by plain copies: to and from a page-locked buffer with
    ``non_blocking=True``, to and from pageable memory, and card to card;
    beside the card to card bound, 2 x bytes over the HBM rate.  One
    buffer of each kind, of the largest size, serves every size."""
    import torch
    sizes = sorted(set(sizes))
    top = sizes[-1]
    dev = torch.empty(top, dtype=torch.uint8, device="cuda")
    dev2 = torch.empty_like(dev)
    pinned = torch.empty(top, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(top, dtype=torch.uint8)

    def ms(fn):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[1]

    out = {}
    for n in sizes:
        d, d2, pin, page = dev[:n], dev2[:n], pinned[:n], pageable[:n]
        out[n] = {
            "d2h_pinned_ms": ms(lambda: pin.copy_(d, non_blocking=True)),
            "h2d_pinned_ms": ms(lambda: d.copy_(pin, non_blocking=True)),
            "d2h_pageable_ms": ms(lambda: page.copy_(d)),
            "h2d_pageable_ms": ms(lambda: d.copy_(page)),
            "d2d_ms": ms(lambda: d2.copy_(d)),
            "d2d_bound_ms": 2 * n / PEAK_BYTES_S * 1e3}
    del dev, dev2, pinned, pageable
    return out


def _move_table(audits) -> dict:
    """Each kind of page move over ``audits``: totals, the largest move's
    own times and rate, and the event clock's modelled time for it (the
    reference's constants: HostOffloadModel 24e9 B/s, InterconnectModel
    50e9 B/s).  ``_with_yardsticks`` adds the plain copies."""
    from repro_torch.core.latency_model import (HostOffloadModel,
                                                InterconnectModel)
    pcie, ic = HostOffloadModel(), InterconnectModel()
    merged: dict = {}
    for pa in audits:
        for kind, rec in pa.moves.items():
            merged.setdefault(kind, []).extend(rec)
    out = {}
    for kind, rec in merged.items():
        if kind.endswith(("_store", "_gather")):
            continue
        # the other half of a two-step move: a swap-out's or demotion's
        # landing in the host pool, a peer promotion's gather to the host
        halves = {h: merged.get(f"{kind}_{h}", []) for h in ("store",
                                                            "gather")}
        big = max(rec, key=lambda r: r["bytes"])
        row = {"moves": len(rec), "pages": sum(r["pages"] for r in rec),
               "bytes": sum(r["bytes"] for r in rec),
               "device_ms": sum(r["device_ms"] or 0.0 for r in rec)
               + sum(r["device_ms"] or 0.0 for r in halves["gather"]),
               "host_ms": sum(r["host_ms"] for r in rec) + sum(
                   r["host_ms"] for h in halves.values() for r in h),
               "largest": {"pages": big["pages"], "bytes": big["bytes"],
                           "device_ms": big["device_ms"],
                           "host_ms": big["host_ms"]}}
        for h, part in halves.items():
            if part:
                row[f"{h}_host_ms"] = sum(r["host_ms"] for r in part)
                row[f"{h}_device_ms"] = sum(r["device_ms"] or 0.0
                                            for r in part)
        row["gb_s"] = row["bytes"] / row["host_ms"] / 1e6
        if kind in ("swap_out", "demote", "swap_in", "host_promote"):
            row["modelled_ms"] = pcie.swap_time(big["bytes"]) * 1e3
        elif kind == "peer_promote":
            row["modelled_ms"] = ic.transfer_time(big["bytes"]) * 1e3
        out[kind] = row
    return out


def _with_yardsticks(tables) -> None:
    """Each row of ``tables`` gets the plain copies of its largest move's
    bytes, each distinct size timed once."""
    yard = _copy_yardsticks([row["largest"]["bytes"] for t in tables
                             for row in t.values()])
    for t in tables:
        for row in t.values():
            row["yardsticks"] = yard[row["largest"]["bytes"]]


def _tier_scenario(name, sc, cfg, params, ctx, lm, fp32):
    """One scenario at full depth in bf16: calm and pressured runs on the
    kernel path, the pressured run on the plain path, both pressured runs
    audited page by page; returns what the phase checks and reports."""
    def run(jobs, kw, impl=None, preempt=(), audit=False):
        return _tier_engine(cfg, params, ctx.with_(impl=impl), jobs,
                            preempt=preempt, audit=audit,
                            **_engine_kw(kw, lm))

    jobs, preempt = fp32["jobs"], fp32["preempt"]
    calm_kw = sc.get("calm_kw", sc["kw"])
    calm, _, c_counts, c_want, c_wall = run(jobs, calm_kw)
    eng, pa, counts, want, wall = run(jobs, sc["kw"], preempt=preempt,
                                      audit=True)
    plain, ppa, p_counts, _, p_wall = run(jobs, sc["kw"], impl="ref",
                                          preempt=preempt, audit=True)
    fires = _fires(name, eng, pa)
    res = {"fires": fires, "plain_fires": _fires(name, plain, ppa),
           "wall_s": {"calm": c_wall, "kernel": wall, "plain": p_wall},
           "launches": {"calm": c_counts, "pressured": counts,
                        "plain": p_counts},
           "predicted": {"calm": c_want, "pressured": want},
           "page_faults": pa.faults + ppa.faults,
           "audit_s": {"kernel": pa.audit_s, "plain": ppa.audit_s},
           "moves": pa.counts(), "drained": _drained(eng),
           "telemetry": _telemetry_audit(eng),
           "same_clock_as_fp32": {
               rid: r.token_times == fp32["calm"].reqs[rid].token_times
               for rid, r in calm.reqs.items()},
           "outputs": {"calm": dict(calm.outputs),
                       "pressured": dict(eng.outputs),
                       "plain": dict(plain.outputs)}}
    emit(phase="serve_tiers", model=cfg.name, scenario=name,
         **{k: v for k, v in res.items() if k != "outputs"},
         outputs={k: {str(r): t for r, t in o.items()}
                  for k, o in res["outputs"].items()})
    res["audit"] = pa
    return res


def _tier_fp32(name, sc, cfg32, params32, ctx, lm):
    """One scenario in fp32 at ``TIER_FP32_LAYERS`` layers: the timing
    probes and calm run, then the pressured run on the kernel and plain
    paths; the tokens of all three must be identical."""
    def run(jobs, kw, impl=None, preempt=()):
        return _tier_engine(cfg32, params32, ctx.with_(impl=impl), jobs,
                            preempt=preempt, **_engine_kw(kw, lm))[0]

    jobs, preempt, calm = _tier_times(sc, run)
    if calm is None:
        calm = run(jobs, sc.get("calm_kw", sc["kw"]))
    kern = run(jobs, sc["kw"], preempt=preempt)
    plain = run(jobs, sc["kw"], impl="ref", preempt=preempt)
    same = dict(calm.outputs) == dict(kern.outputs) == dict(plain.outputs)
    fires = _fires(name, kern)
    emit(phase="serve_tiers", model=cfg32.name, dtype="float32",
         layers=cfg32.n_layers, scenario=name, fires=fires,
         identical=same, preempt=preempt,
         arrivals={str(j[0]): j[1] for j in jobs},
         outputs={str(k): v for k, v in kern.outputs.items()})
    check(fires["ok"], f"serve_tiers fp32 {name}: the mechanism did not "
          f"fire: {fires}")
    check(same, f"serve_tiers fp32 {name}: tokens differ between the calm "
          "run, the pressured kernel run and the plain run")
    check(fires.get("twin_decodes_as_a", True), f"serve_tiers fp32 {name}: "
          "the twin promoted from the host tier decodes other tokens")
    return {"jobs": jobs, "preempt": preempt, "calm": calm,
            "outputs": dict(calm.outputs)}


def _tier_mesh(name, sc, cfg, params, lm, fp32, cfg32, params32, n):
    """(g): scenario ``name`` on the ``n``-position mesh of the one card,
    both decode pools striped ``n`` ways: fp32 tokens equal the
    unsharded calm run's; the bf16 run audited and checked as on one
    device."""
    mesh = _sp_context()
    kw = _engine_kw(sc["kw"], lm)
    eng32 = _tier_engine(cfg32, params32, mesh, fp32["jobs"],
                         preempt=fp32["preempt"], **kw)[0]
    same = dict(eng32.outputs) == fp32["outputs"]
    eng, pa, counts, want, wall = _tier_engine(
        cfg, params, mesh, fp32["jobs"], preempt=fp32["preempt"],
        audit=True, **kw)
    fires = _fires(name, eng, pa)
    res = {"fires": fires, "fp32_fires": _fires(name, eng32),
           "fp32_identical": same, "wall_s": wall, "launches": counts,
           "predicted": want, "page_faults": pa.faults,
           "audit_s": pa.audit_s, "moves": pa.counts(),
           "drained": _drained(eng),
           "telemetry": _telemetry_audit(eng),
           "kv_shards": [d.kv_shards for d in eng.dstates]
           + [eng.pkv.kv_shards]}
    emit(phase="serve_tiers", model=cfg.name, mesh=n, scenario=name,
         **res, outputs={str(k): v for k, v in eng.outputs.items()})
    res["outputs"], res["audit"] = dict(eng.outputs), pa
    return res


def _tier_gates(tag, res) -> None:
    """The gates every audited bf16 run must pass."""
    d = res["drained"]
    t = res["telemetry"]
    check(res["fires"]["ok"], f"{tag}: the mechanism did not fire: "
          f"{res['fires']}")
    check(not res["page_faults"], f"{tag}: page moves not bit-exact: "
          f"{res['page_faults']}")
    check(d["free_pages"] and d["swapped_now"] == 0 and d["leases"] == 0
          and d["swap_gauges"] == 0, f"{tag}: not drained: {d}")
    check(t["attribution_bit_equal"] and t["open_spans"] == 0
          and t["chrome_events"][0] == t["chrome_events"][1]
          and t.get("fabric_counters_agree", True),
          f"{tag}: telemetry audit failed: {t}")


def phase_serve_tiers() -> dict:
    """Llama-3-8B at full width, bf16, through the ServingEngine with
    ``launch/serve.py``'s ClusterSpec (16 prefill, 2 decode instances),
    pages of 64: the six tier scenarios (a)-(f) of ``_tier_scenarios`` on
    one device and (a), (c) on the 4-position mesh (g).  Every scenario
    runs first in fp32 at ``TIER_FP32_LAYERS`` layers (timing probes and
    calm runs; tokens identical between calm, pressured and plain runs),
    then at full depth in bf16: calm and pressured runs on the kernel
    path, the pressured run on the plain path.  Gates: each mechanism
    fires; every page move bit-exact (``PageAudit``); K1-K3 launch as
    the trace predicts; every stream under the tie rule of phase
    serve_sp; telemetry audits; everything drained.  Prints the page
    moves' times beside plain copies and the event clock's model.
    Returns the launch counts of the bf16 kernel-path runs by path."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core import latency_model as lm
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.sharding import make_context
    cfg = get_config("llama3-8b")
    ctx = make_context("cuda")
    cfg32 = dataclasses.replace(cfg, n_layers=TIER_FP32_LAYERS,
                                dtype="float32")
    params32 = init_params(cfg32, seed=11, device=ctx.device)
    scen = _tier_scenarios(cfg.vocab_size)
    emit(phase="serve_tiers", fp32_cut=f"fp32 runs at {TIER_FP32_LAYERS} of "
         f"{cfg.n_layers} layers (full widths): exact tokens need fp32, "
         "and the event clock does not depend on the depth")
    t0 = time.perf_counter()
    fp32 = {name: _tier_fp32(name, sc, cfg32, params32, ctx, lm)
            for name, sc in scen.items()}
    fp32_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=ctx.device)
    torch.cuda.synchronize()
    emit(phase="serve_tiers", model=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, params=count_params(params),
         init_s=round(time.perf_counter() - t0, 2), fp32_s=round(fp32_s, 2))
    stage_s = {"fp32": fp32_s}
    t0 = time.perf_counter()
    res = {}
    for name, sc in scen.items():
        _free()
        res[name] = _tier_scenario(name, sc, cfg, params, ctx, lm,
                                   fp32[name])
    stage_s["bf16"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = {}
    for name in ("placed_swap", "peer_promote"):
        _free()
        mesh[name] = _tier_mesh(name, scen[name], cfg, params, lm,
                                fp32[name], cfg32, params32, SP)
    stage_s["mesh"] = time.perf_counter() - t0
    # the gates
    by_path = {"serve_tiers": dict.fromkeys(SOURCES, 0),
               "sp_fabric": dict.fromkeys(SOURCES, 0)}
    for name, r in res.items():
        _tier_gates(f"serve_tiers {name}", r)
        check(r["plain_fires"]["ok"] and not any(
            r["launches"]["plain"].values()),
            f"serve_tiers {name}: the plain path launched kernels or its "
            f"mechanism did not fire: {r['launches']['plain']}")
        check(all(r["same_clock_as_fp32"].values()),
              f"serve_tiers {name}: the bf16 event clock differs from the "
              "fp32 runs'")
        for run in ("calm", "pressured"):
            got = r["launches"][run]
            want = {k: r["predicted"][run].get(k, 0) for k in got}
            check(got == want, f"serve_tiers {name} {run}: launches {got} "
                  f"where the trace predicts {want}")
            for k, v in got.items():
                by_path["serve_tiers"][k] += v
    for name, r in mesh.items():
        _tier_gates(f"serve_tiers mesh {name}", r)
        check(r["fp32_fires"]["ok"] and r["fp32_identical"],
              f"serve_tiers mesh {name}: fp32 tokens differ from the "
              "unsharded engine's, or the mechanism did not fire")
        check(r["kv_shards"] == [SP] * 3,
              f"serve_tiers mesh {name}: pools striped {r['kv_shards']}")
        want = {k: r["predicted"].get(k, 0) for k in r["launches"]}
        check(r["launches"] == want, f"serve_tiers mesh {name}: launches "
              f"{r['launches']} where the trace predicts {want}")
        for k, v in r["launches"].items():
            by_path["sp_fabric"][k] += v
    _check_launches(by_path["serve_tiers"], "serve_tiers")
    _check_launches(by_path["sp_fabric"], "sp_fabric")
    # bf16 streams: every request whose streams part anywhere is
    # teacher-forced along the calm run's stream under the tie rule (a
    # stream no engine parts from is identical, token for token); twins
    # with one prompt and one calm stream replay once
    t0 = time.perf_counter()
    ties, replays = {}, {}
    for name, r in res.items():
        sc = scen[name]
        prompts = {j[0]: j[2] for j in sc["jobs"]}
        got = {"pressured": r["outputs"]["pressured"],
               "plain": r["outputs"]["plain"]}
        if name in mesh:
            got["mesh"] = mesh[name]["outputs"]
        want = r["outputs"]["calm"]
        rids = [rid for rid, a in want.items()
                if any(g[rid] != a for g in got.values())]
        if not rids:
            ties[name] = {"identical": True}
            continue
        ties[name] = _stream_ties(
            cfg, params, {"kernel": ctx, "plain": ctx.with_(impl="ref")},
            prompts, {rid: want[rid] for rid in rids}, got,
            replays=replays)
    emit(phase="serve_tiers", model=cfg.name, stream_ties=ties,
         tie_tol=TIE_TOL)
    check(all(o["tie"] for t in ties.values() if "identical" not in t
              for rr in t.values() for o in rr["others"]),
          f"serve_tiers: a stream parts from its calm run at a step that is "
          f"no tie: {ties}")
    stage_s["ties"] = time.perf_counter() - t0
    # the page moves' numbers
    t0 = time.perf_counter()
    one = _move_table([r["audit"] for r in res.values()])
    striped = _move_table([r["audit"] for r in mesh.values()])
    _with_yardsticks([one, striped])
    emit(phase="serve_tiers", model=cfg.name, moves=one)
    emit(phase="serve_tiers", model=cfg.name, mesh=SP, moves=striped)
    stage_s["yardsticks"] = time.perf_counter() - t0
    emit(phase="serve_tiers", launches=by_path, stage_s=stage_s)
    del params, params32
    _free()
    return by_path


# ---------------------------------------------------------------- phase 4
def _dense_run(cfg, params, ctx, prompts, chunks, ticks, force=None,
               frames=None, positions=None, decode_ctx=None, max_seq=None):
    """CDSP chunked prefill over a dense history (an encoder-decoder's
    with its ``frames``), the hand-off to dense decode caches, then
    ``ticks`` dense decode ticks, greedy (or on the tokens ``force``).
    ``prompts``: one prompt, or a batch of prompts of one length, stored
    in the order ``positions`` gives (default natural; a zigzag layout's
    positions on a mesh).  ``decode_ctx`` (default ``ctx``) runs the
    hand-off and the ticks: on a split-KV context the caches are laid out
    in sequence shards over its split axis.  The caches hold ``max_seq``
    slots (default the prompt and the ticks).  Returns
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
    dctx = ctx if decode_ctx is None else decode_ctx
    toks = torch.as_tensor(np.atleast_2d(prompts), device=dev)
    B, L = toks.shape
    pos = (torch.arange(L, dtype=torch.int32, device=dev) if positions is None
           else torch.as_tensor(positions, dtype=torch.int32,
                                device=dev))[None].expand(B, L)
    toks = torch.gather(toks, 1, pos.long())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    before = _read_counts()
    ev[0].record()
    logits, hist = chunked_prefill(params, cfg, ctx, toks, pos, chunks,
                                   encoder_frames=frames)
    caches, clen = history_to_decode_caches(
        cfg, hist, max_seq=L + ticks if max_seq is None else max_seq,
        ctx=dctx if dctx.mesh is not None else None)
    ev[1].record()
    prefill_launches = {k: v - before[k] for k, v in _read_counts().items()}
    del hist
    rows = [logits[:, 0, :cfg.vocab_size].float()]
    out = [rows[0].argmax(-1).tolist() if force is None else force[0]]
    tick_ms = []
    for i in range(ticks):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        lg, _, caches = forward(params, cfg, dctx,
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


# ------------------------------------------------- phase 3d: sp_families
# the trace of the serve phases, and the dense path's prompt and ticks
SP_LENS = (512, 2048, 4096, 6144)
SP_DENSE_PROMPT, SP_DENSE_TICKS = 6144, 16


def sp_k5_launches(cfg, lens) -> int:
    """K5 launches of the trace (each prompt two chunks) on the ``SP``-
    position mesh engine: a chunk that divides into whole scan chunks a
    position runs ``sp_ssd``, one scan a position and layer; any other
    chunk one scan a layer (models/ssm.py)."""
    chunk = cfg.ssm.chunk_size
    calls = 0
    for L in lens:
        for c in (L // 2, L - L // 2):
            calls += SP if c % SP == 0 and (c // SP) % min(chunk, c) == 0 \
                else 1
    return calls * cfg.n_layers


def sp_moe_launches(cfg, lens, ticks: int) -> dict:
    """K1/K3 launches and EP islands of the trace on the mesh engine with
    ``moe_ep``: a first chunk rings SP x SP K3 calls a layer, a history
    chunk twice that (own KV, then the striped slab), a tick one K1 call a
    shard and layer; a chunk's MoE layers take EP where its 512-token
    groups divide over the SP axis, every tick's (a tick has no token
    axis)."""
    from repro_torch.models.moe import GROUP_SIZE
    ep_chunks = sum(1 for L in lens for c in (L // 2, L - L // 2)
                    if -(-c // min(GROUP_SIZE, c)) % SP == 0)
    return {"flash_attention": 3 * SP * SP * cfg.n_layers * len(lens),
            "paged_flash_decode": SP * cfg.n_layers * ticks,
            "paged_flash_prefill": 0,
            "ep_prefill": ep_chunks * cfg.n_layers,
            "ep_tick": ticks * cfg.n_layers}


def sp_dense_launches(n_layers: int, ticks: int) -> dict:
    """The dense path on the mesh: the zigzag ring makes one K3 call a
    position at step 0 and two at each later step (SP + 2 SP (SP - 1) a
    layer), the contiguous ring SP x SP; each tick one K4 call a shard and
    layer."""
    return {"zigzag_K3": n_layers * (SP + 2 * SP * (SP - 1)),
            "contiguous_K3": n_layers * SP * SP,
            "K4": n_layers * ticks * SP}


@contextlib.contextmanager
def ep_islands():
    """Count the expert-parallel islands run inside the block, a chunk's
    (its groups split over the SP axis) apart from a tick's (no token
    axis under serve_paged)."""
    from repro_torch.models import moe
    island = moe._moe_ep
    seen = {"prefill": 0, "tick": 0}

    def call(*args):
        seen["tick" if args[-1] is None else "prefill"] += 1
        return island(*args)

    moe._moe_ep = call
    try:
        yield seen
    finally:
        moe._moe_ep = island


def _serve_runs(phase, cfg, params, prompts, ctxs: dict, out_len: int):
    """The trace on one engine per context of ``ctxs``; per engine its
    launches, outputs, plans, the EP islands it ran, and the device us
    per chunk and tick."""
    import torch
    runs = {}
    for name, c in ctxs.items():
        _free()
        _reset_counts()
        t0 = time.perf_counter()
        with ep_islands() as ep:
            eng = _serve(cfg, params, prompts, c, out_len, max_seq=6208,
                         prefill_pool_blocks=256, host_pool_blocks=128,
                         profile_ops=True)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = {"launches": _read_counts(), "ep_islands": dict(ep),
                      "outputs": dict(eng.outputs),
                      "plans": {rid: r.chunk_plan
                                for rid, r in eng.reqs.items()},
                      "chunk_device_us": _hist(
                          eng, "op_device_us/prefill_chunk"),
                      "tick_device_us": _hist(eng,
                                              "op_device_us/decode_tick"),
                      # the ticks the engine ran (its profiled tick ops)
                      "ticks": (_hist(eng, "op_device_us/decode_tick")
                                or _hist(eng, "op_wall_us/decode_tick")
                                )["count"]}
        emit(phase=phase, model=cfg.name, engine=name,
             wall_s=round(wall, 2), **{k: v for k, v in runs[name].items()
                                       if k not in ("outputs", "plans")},
             outputs={str(k): v for k, v in eng.outputs.items()})
        del eng
    emit(phase=phase, model=cfg.name, device_ms={f"{op}_mean": {
        k: r[f"{op}_device_us"]["mean"] / 1e3
        for k, r in runs.items() if r[f"{op}_device_us"]}
        for op in ("chunk", "tick")})
    return runs


def _sp_mamba() -> dict:
    """Mamba-2-1.3B at full width, bf16, on the unsharded engine and on
    the ``SP``-position mesh engine (both pools striped; chunks that
    divide into whole 256-token scan chunks a position run ``sp_ssd``,
    the 256-token chunks of the 512-token prompt one scan).  K5 launches
    exactly ``sp_k5_launches``; every step of the unsharded engine's
    streams held by the tie rule on three paths; the longest request's
    mesh replay holds each of its K5 calls (one a position) to the plain
    scan, planted faults rejected, and its logits to the plain path's
    within Mamba's limit."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.sharding import make_context
    cfg = get_config("mamba2-1.3b")
    ctx, sp_ctx = make_context("cuda"), _sp_context()
    params = init_params(cfg, seed=0, device=ctx.device)
    emit(phase="sp_families", model=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, params=count_params(params), positions=SP)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in SP_LENS]
    out_len = 16
    runs = _serve_runs("sp_families", cfg, params, prompts,
                       {"unsharded": ctx, "sharded": sp_ctx}, out_len)
    sh, flat = runs["sharded"], runs["unsharded"]
    counts = sh["launches"]
    want_k5 = sp_k5_launches(cfg, SP_LENS)
    emit(phase="sp_families", model=cfg.name,
         k5_launches={"sharded": counts["ssd_scan"], "predicted": want_k5,
                      "unsharded": flat["launches"]["ssd_scan"]})
    _check_launches(counts, "sp_mamba")
    check(counts["ssd_scan"] == want_k5,
          f"sp_families: Mamba-2 launched K5 {counts['ssd_scan']} times, "
          f"predicted {want_k5}")
    ties = _stream_ties(cfg, params, {"unsharded": ctx, "sharded": sp_ctx,
                                      "plain": ctx.with_(impl="ref")},
                        prompts, flat["outputs"], {"sharded": sh["outputs"]})
    emit(phase="sp_families", model=cfg.name, stream_ties=ties,
         tie_tol=TIE_TOL, steps_checked=sum(r["steps"] for r in ties.values()))
    check(all(o["tie"] for r in ties.values() for o in r["others"]),
          "sp_families: a Mamba-2 path's greedy token differs from the "
          f"unsharded engine's at a step that is no tie: {ties}")
    rid = len(SP_LENS) - 1
    first = flat["outputs"][rid][0]
    _free()
    got, gate = ssd_call_gate(
        lambda: _replay(cfg, params, sp_ctx, prompts[rid], [first]),
        cfg.n_layers, per=SP)
    emit(phase="sp_families", model=cfg.name, ssd_calls=gate,
         tol={k: SSD_TOL[k] for k in ("bfloat16", "h_final")})
    check(gate["ok"], "sp_families: a K5 call of the Mamba-2 mesh replay "
          f"disagrees with the plain scan, or a planted fault passed: {gate}")
    check(int(torch.argmax(got[1])) == first,
          "sp_families: the Mamba-2 mesh replay disagrees with the "
          "engine's first token")
    want = _replay(cfg, params, ctx.with_(impl="ref"), prompts[rid], [first])
    _logits_vs_plain("sp_families", ("mamba_chunk1", "mamba_chunk2",
                                     "mamba_tick"), got, want,
                     LOGIT_TOL["mamba2-1.3b"])
    del got, want
    _free()
    emit(phase="sp_families", model=cfg.name,
         k5_position_calls=_k5_position_times(cfg))
    del params
    _free()
    return counts


def _k5_position_times(cfg) -> dict:
    """One K5 call's time at the mesh's per-position shapes (the 1024-,
    2048- and 3072-token chunks over ``SP`` positions, no incoming state),
    by CUDA events with the card held busy, beside its bound and the plain
    scan's time."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(2)
    s = cfg.ssm
    H = s.expand * cfg.d_model // s.head_dim
    P, G, N, chunk = s.head_dim, s.ngroups, s.d_state, s.chunk_size
    out = {}
    for S in (1024 // SP, 2048 // SP, 3072 // SP):
        d_in = H * P
        xbc = torch.randn(1, S, d_in + 2 * G * N, generator=gen).to(
            dev, torch.bfloat16)
        x = xbc[..., :d_in].reshape(1, S, H, P)
        Bm = xbc[..., d_in:d_in + G * N].reshape(1, S, G, N)
        Cm = xbc[..., d_in + G * N:].reshape(1, S, G, N)
        dt = torch.exp(torch.empty(1, S, H).uniform_(
            -6.9, -2.3, generator=gen)).to(dev)
        A = -torch.empty(H).uniform_(1.0, 16.0, generator=gen).to(dev)
        got = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        want = ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
        bms, by = ssd_bound_ms(1, S, H, P, G, N, chunk, "bfloat16", False)
        out[f"tokens_{S}"] = {
            "ratios": ssd_ratios(got, want),
            "ms": event_ms(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=chunk),
                           cold=False),
            "plain_ms": event_ms(lambda: ssd_scan_plain(
                x, dt, A, Bm, Cm, chunk=chunk), cold=False, n=3),
            "bound_ms": bms, "bound_by": by}
        check(max(out[f"tokens_{S}"]["ratios"].values()) <= 1.0,
              f"sp_families: K5 at {S} tokens disagrees with the plain scan")
    return out


def _sp_moe() -> dict:
    """Qwen1.5-MoE-A2.7B at full width, bf16, on the unsharded engine and
    on the ``SP``-position mesh engine with expert parallelism (each
    position owns 15 of the 60 experts): K1/K3 launches and EP islands
    exactly ``sp_moe_launches``; the routing of the longest request's
    mesh replay beside the unsharded replay's and the mesh plain path's;
    the replay holds each K1/K3 call to its plain version (planted faults
    rejected) and its logits within Qwen's limit to the plain path of the
    same program (the mesh with EP, plain kernels); the logits against
    the unsharded plain path are printed beside them."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import count_params, init_params
    from repro_torch.models.sharding import make_context
    cfg = get_config("qwen2-moe-a2.7b")
    ctx, ep_ctx = make_context("cuda"), _sp_context().with_(moe_ep=True)
    params = init_params(cfg, seed=0, device=ctx.device)
    emit(phase="sp_families", model=cfg.name, dtype=cfg.dtype,
         layers=cfg.n_layers, params=count_params(params), positions=SP,
         experts_a_position=cfg.moe.n_experts // SP)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in SP_LENS]
    out_len = 16
    runs = _serve_runs("sp_families", cfg, params, prompts,
                       {"unsharded": ctx, "sharded_ep": ep_ctx}, out_len)
    sh, flat = runs["sharded_ep"], runs["unsharded"]
    counts = sh["launches"]
    ticks = sh["ticks"]
    want = sp_moe_launches(cfg, SP_LENS, ticks)
    got_n = {**{k: counts[k] for k in ("flash_attention",
                                       "paged_flash_decode",
                                       "paged_flash_prefill")},
             "ep_prefill": sh["ep_islands"]["prefill"],
             "ep_tick": sh["ep_islands"]["tick"]}
    emit(phase="sp_families", model=cfg.name, ticks=ticks,
         launches_vs_predicted={"got": got_n, "predicted": want},
         tokens_identical={str(r): sh["outputs"][r] == t
                           for r, t in flat["outputs"].items()})
    _check_launches(counts, "sp_moe")
    check(got_n == want, f"sp_families: Qwen1.5-MoE on the mesh launched "
          f"{got_n}, predicted {want}")
    check(not any(flat["ep_islands"].values()),
          "sp_families: the unsharded engine ran an EP island")
    rid = len(SP_LENS) - 1
    first = flat["outputs"][rid][0]
    _free()
    with moe_routes() as got_routes:
        got, gate = attn_call_gate(
            lambda: _replay(cfg, params, ep_ctx, prompts[rid], [first]),
            *sp_gate_plan(cfg.n_layers))
    emit(phase="sp_families", model=cfg.name, attention_calls=gate,
         tol=KERNEL_TOL["bfloat16"])
    check(gate["ok"], "sp_families: a K1/K3 call of the Qwen mesh replay "
          f"disagrees with its plain version, or a planted fault passed: "
          f"{gate}")
    with moe_routes() as flat_routes:
        _replay(cfg, params, ctx, prompts[rid], [first])
    with moe_routes() as want_routes:
        want_rows = _replay(cfg, params, ep_ctx.with_(impl="ref"),
                            prompts[rid], [first])
    flat_plain = _replay(cfg, params, ctx.with_(impl="ref"), prompts[rid],
                         [first])
    rows = ("chunk1", "chunk2_history", "decode_tick")
    emit(phase="sp_families", model=cfg.name,
         routing_vs_unsharded=routing_diff(got_routes, flat_routes,
                                           cfg.n_layers, rows),
         routing_vs_mesh_plain=routing_diff(got_routes, want_routes,
                                            cfg.n_layers, rows),
         logits_vs_unsharded_plain={
             r: {"max_abs_err": float((a - b).abs().max()),
                 "cos": float(torch.nn.functional.cosine_similarity(
                     a, b, dim=0))}
             for r, a, b in zip(rows, got, flat_plain)})
    del got_routes, flat_routes, want_routes, flat_plain
    # held to the plain path of the same program: the mesh with EP, plain
    # kernels.  Against the unsharded plain path (printed above) the
    # tick's routing flips near ties in 14 of 24 layers on a right path:
    # the mesh without EP reads the same (tools/moe_logits_floor.py,
    # PERF.md section 6)
    _logits_vs_plain("sp_families", tuple(f"moe_{r}" for r in rows), got,
                     want_rows, LOGIT_TOL["qwen2-moe-a2.7b"])
    del got, want_rows, params
    _free()
    return counts


def dense_gate_plan(n_layers: int):
    """(calls, keep) of ``attn_call_gate`` for the dense mesh path's
    zigzag prefill and first tick: K3 in the order (layer, step,
    position), one call a position at step 0 and two (A, then B) at each
    later step; K4 one a shard and layer.  Kept: the first layer's first
    step-0 call and its first later-step pair, the last layer's last
    pair, and the tick's first and last K4 calls."""
    per = sp_dense_launches(n_layers, 1)
    c, k4 = per["zigzag_K3"], per["K4"]
    return ({"flash_attention": c, "flash_decode": k4},
            {"flash_attention": (0, SP, SP + 1, c - 2, c - 1),
             "flash_decode": (0, k4 - 1)})


def _sp_dense() -> dict:
    """Llama-3-8B at full width, bf16: a 6144-token prompt prefilled whole
    on one position, on the ``SP``-position mesh in contiguous order, and
    in zigzag order with the causal skip; the zigzag run hands its KV to
    dense caches split ``SP`` ways over a decode context's split axis and
    runs 16 split-KV ticks (K4 a shard).  Launches exactly
    ``sp_dense_launches``; the zigzag prefill and first tick are replayed
    with each K3/K4 call held to its plain version (planted faults
    rejected) and their logits held to the plain path's."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.zigzag import zigzag_permutation
    from repro_torch.launch.mesh import make_context as mesh_context
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    cfg = get_config("llama3-8b")
    ctx = make_context("cuda")
    pre = mesh_context(make_mesh((SP,), ("data",), device="cuda"), "prefill")
    zz = pre.with_(zigzag_skip=True)
    dec = mesh_context(make_mesh((1, SP), ("data", "model"), device="cuda"),
                       "decode")
    params = init_params(cfg, seed=0, device=ctx.device)
    L, ticks = SP_DENSE_PROMPT, SP_DENSE_TICKS
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, L).astype(np.int32)
    perm = zigzag_permutation(L, SP)
    want_n = sp_dense_launches(cfg.n_layers, ticks)
    runs = {}
    for name, pc, dc, pos in (("unsharded", ctx, ctx, None),
                              ("mesh_contiguous", pre, ctx, None),
                              ("mesh_zigzag", zz, dec, perm)):
        _free()
        _reset_counts()
        # one untimed run first: the first calls at new shapes
        _dense_run(cfg, params, pc, prompt, [L], 1, positions=pos,
                   decode_ctx=dc, max_seq=L + ticks)
        _reset_counts()
        run = _dense_run(cfg, params, pc, prompt, [L], ticks, positions=pos,
                         decode_ctx=dc)
        counts = _read_counts()
        tick_ms = run["tick_ms"]
        runs[name] = {"launches": counts,
                      "prefill_launches": run["prefill_launches"],
                      "tokens": [t[0] for t in run["tokens"]],
                      "prefill_ms": run["prefill_ms"],
                      "tick_ms_mean": sum(tick_ms) / len(tick_ms)}
        emit(phase="sp_families", model=cfg.name, path="dense",
             engine=name, **runs[name],
             clock="cuda events around the prefill (with its hand-off) and "
                   "each tick")
        del run
    z = runs["mesh_zigzag"]
    got_n = {"zigzag_K3": z["prefill_launches"]["flash_attention"],
             "contiguous_K3":
                 runs["mesh_contiguous"]["prefill_launches"][
                     "flash_attention"],
             "K4": z["launches"]["flash_decode"]}
    emit(phase="sp_families", model=cfg.name, path="dense",
         launches_vs_predicted={"got": got_n, "predicted": want_n},
         tokens_identical={n: r["tokens"] == runs["unsharded"]["tokens"]
                           for n, r in runs.items()})
    _check_launches(z["launches"], "sp_dense")
    check(got_n == want_n, f"sp_families: the dense mesh path launched "
          f"{got_n}, predicted {want_n}")
    _free()
    force = [[t] for t in z["tokens"][:2]]
    got, gate = attn_call_gate(
        lambda: _dense_run(cfg, params, zz, prompt, [L], 1, force=force,
                           positions=perm, decode_ctx=dec,
                           max_seq=L + ticks),
        *dense_gate_plan(cfg.n_layers))
    emit(phase="sp_families", model=cfg.name, path="dense",
         attention_calls=gate, tol=KERNEL_TOL["bfloat16"])
    check(gate["ok"], "sp_families: a K3/K4 call of the dense mesh replay "
          f"disagrees with its plain version, or a planted fault passed: "
          f"{gate}")
    want = _dense_run(cfg, params, ctx.with_(impl="ref"), prompt, [L], 1,
                      force=force)
    _logits_vs_plain("sp_families", ("dense_zigzag_prefill",
                                     "dense_split_tick1"),
                     [r[0] for r in got["rows"]],
                     [r[0] for r in want["rows"]], LOGIT_TOL["llama3-8b"])
    del got, want
    _free()
    emit(phase="sp_families", model=cfg.name, path="dense",
         shard_calls=_dense_shard_times(cfg, L, ticks))
    del params
    _free()
    return z["launches"]


def _dense_shard_times(cfg, L: int, ticks: int) -> dict:
    """One call's time at the dense mesh path's per-position shapes, by
    CUDA events with the card held busy, beside its bound and its plain
    version's time: K3 at the zigzag ring's step 0 (a position's L / SP
    queries over its own keys, slices 0 and 2 SP - 1, causal) and at a
    later step (L / 2 SP queries over as many keys, all visible), and K4
    over the first and the last of the SP shards of an (L + ticks)-slot
    cache at the first tick (length L + 1)."""
    import torch
    from repro_torch.core.zigzag import zigzag_permutation
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(4)
    H, KVH, D = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim_

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    out = {}
    s = L // SP
    perm = torch.as_tensor(zigzag_permutation(L, SP)[:s], dtype=torch.int32,
                           device=dev)
    half = s // 2
    cases = {"k3_step0_diagonal": (s, perm, perm),
             "k3_later_half": (half, perm[half:], perm[:half])}
    for name, (n, qp, kp) in cases.items():
        q, k, v = randn(1, n, H, D), randn(1, n, KVH, D), randn(1, n, KVH, D)
        pairs = int((kp[None, :] <= qp[:, None]).sum())
        bms, by = ring_step_bound_ms(n, H, KVH, D, pairs)
        o, lse = flash_attention(q, k, v, qp, kp)
        po, pl = flash_attention_plain(q, k, v, qp, kp)
        tol = KERNEL_TOL["bfloat16"]
        mask = (kp[None, :] <= qp[:, None])[None]
        out[name] = {
            "queries": n, "keys": n, "visible_pairs": pairs,
            "o_ratio": close_ratio(o, po, tol["atol"], tol["rtol"]),
            "ms": event_ms(lambda: flash_attention(q, k, v, qp, kp),
                           cold=False),
            "plain_ms": event_ms(lambda: flash_attention_plain(
                q, k, v, qp, kp), cold=False, n=3),
            "library_ms": event_ms(_sdpa(q, k, v, None, causal=False)
                                   if pairs == n * n
                                   else _sdpa(q, k, v, mask), cold=False),
            "bound_ms": bms, "bound_by": by}
    s_loc = (L + ticks) // SP
    ln = torch.tensor([L + 1], dtype=torch.int32, device=dev)
    for i in (0, SP - 1):
        q, k, v = randn(1, H, D), randn(1, s_loc, KVH, D), \
            randn(1, s_loc, KVH, D)
        off = i * s_loc
        keys = max(0, min(s_loc, L + 1 - off))
        nbytes = 2 * H * D * 2 + 2 * keys * KVH * D * 2 + H * 4 + 4
        bms, by = bound_ms(nbytes, 4 * H * D * keys, "bfloat16")
        o, _ = flash_decode(q, k, v, ln, kv_offset=off)
        po, _ = flash_decode_plain(q, k, v, ln, kv_offset=off)
        tol = KERNEL_TOL["bfloat16"]
        out[f"k4_shard{i}"] = {
            "keys": s_loc, "valid_keys": keys, "kv_offset": off,
            "o_ratio": close_ratio(o, po, tol["atol"], tol["rtol"]),
            "ms": event_ms(lambda: flash_decode(q, k, v, ln, kv_offset=off),
                           cold=True),
            "warm_ms": event_ms(lambda: flash_decode(q, k, v, ln,
                                                     kv_offset=off),
                                cold=False),
            "plain_ms": event_ms(lambda: flash_decode_plain(
                q, k, v, ln, kv_offset=off), cold=False, n=3),
            # the library over the shard's valid keys (none: not timed)
            "library_ms": event_ms(_sdpa(
                q[:, None], k[:, :keys], v[:, :keys], None, causal=False),
                cold=True) if keys else None,
            "bound_ms": bms, "bound_by": by}
    check(all(r["o_ratio"] <= 1.0 for r in out.values()),
          f"sp_families: a K3/K4 call at the mesh shapes disagrees: {out}")
    return out


def phase_sp_families() -> dict:
    """Sequence parallelism for every family on the ``SP`` positions of
    the one card, each path at full width in bf16 and freed before the
    next: Mamba-2 (``sp_ssd``), Qwen1.5-MoE with expert parallelism, and
    Llama-3-8B's dense path (zigzag causal-skip ring, split-KV dense
    decode).  Returns the launch counts of the three mesh runs."""
    return {"sp_mamba": _sp_mamba(), "sp_moe": _sp_moe(),
            "sp_dense": _sp_dense()}


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
def _tokens_engine(arch: str, path: str, seed: int, lens, out_len: int,
                   first: int = 0, max_seq: int = 4096,
                   prefill_pool_blocks: int = 160):
    """fp32 at two layers and full widths (a longer pattern: its
    published layers ``first`` and ``first + 1``): the engine's greedy
    tokens on the kernel path and on the plain path.  Returns (cfg,
    params, ctx, prompts, kernel-path outputs)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models.params import init_params
    from repro_torch.models.sharding import make_context
    cfg = dataclasses.replace(cut_depth(get_config(arch), 2, first),
                              dtype="float32")
    ctx = make_context("cuda")
    params = init_params(cfg, seed=seed, device=ctx.device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in lens]
    outs = {}
    for impl in (None, "ref"):
        _reset_counts()
        eng = _serve(cfg, params, prompts, ctx.with_(impl=impl), out_len,
                     max_seq=max_seq, prefill_pool_blocks=prefill_pool_blocks,
                     host_pool_blocks=64)
        counts = _read_counts()
        outs[impl or "cuda"] = dict(eng.outputs)
        emit(phase="tokens", model=cfg.name, impl=impl or "cuda",
             layers=[f"{s.mixer}+{s.ffn}" for s in cfg.pattern]
             * cfg.n_blocks, launches=counts,
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
    """The same fp32 trace on the mesh engines: the ``SP``-position
    engine (chunks of 150 and 1250 tokens do not divide over its ring
    and take the striped history's gather fallback, K3 over slab ++
    chunk; the others ring), the same restriped live as in
    ``serve_elastic`` (2 active shards, 4 between the longest request's
    tokens 2 and 3, 2 after its tokens 4 and 5), and the TP x SP engine
    on the 2 x 2 mesh; the tokens must be the unsharded kernel and plain
    engines'."""
    kw = dict(max_seq=4096, prefill_pool_blocks=160, host_pool_blocks=64)
    tt = None
    for name, path in (("sharded", "serve_sp"), ("restriped", "serve_elastic"),
                       ("tp", "serve_tp")):
        _reset_counts()
        if name == "restriped":
            eng, _ = _serve_resized(
                cfg, params, prompts, _sp_context(), out_len,
                [(2, None), (4, 0.5 * (tt[2] + tt[3])),
                 (2, 0.5 * (tt[4] + tt[5]))], **kw)
        else:
            eng = _serve(cfg, params, prompts,
                         _tp_context() if name == "tp" else _sp_context(),
                         out_len, **kw)
        if tt is None:
            tt = eng.reqs[len(prompts) - 1].token_times
        counts = _read_counts()
        _check_launches(counts, path)
        same = dict(eng.outputs) == outs
        emit(phase="tokens", model=cfg.name, impl="cuda", engine=name,
             mesh=repr(eng.ctx.mesh), launches=counts, identical=same,
             restripe_log=list(eng.restripe_log),
             outputs={str(k): v for k, v in eng.outputs.items()})
        check(same, f"{cfg.name}: fp32 greedy tokens of the {name} mesh "
              "engine differ from the unsharded engines'")
        if name == "restriped":
            check([e["n_new"] for e in eng.restripe_log] == [2, 4, 2],
                  f"{cfg.name}: restripe log {eng.restripe_log}")
        del eng
        _free()


def _tokens_mesh(cfg, params, ctx, prompts, outs, out_len: int, path: str,
                 mesh_ctx) -> None:
    """The fp32 trace on the mesh engine of ``mesh_ctx``: its tokens must
    be the unsharded kernel and plain engines' ``outs``."""
    _reset_counts()
    with ep_islands() as ep:
        eng = _serve(cfg, params, prompts, mesh_ctx, out_len, max_seq=4096,
                     prefill_pool_blocks=160, host_pool_blocks=64)
    counts = _read_counts()
    _check_launches(counts, path)
    same = dict(eng.outputs) == outs
    emit(phase="tokens", model=cfg.name, impl="cuda", engine=path,
         mesh=repr(mesh_ctx.mesh), launches=counts, ep_islands=dict(ep),
         identical=same, outputs={str(k): v for k, v in eng.outputs.items()})
    check(same, f"{cfg.name}: fp32 greedy tokens of the {path} mesh engine "
          "differ from the unsharded engines'")
    check(not mesh_ctx.moe_ep or ep["prefill"] and ep["tick"],
          f"{cfg.name}: the EP mesh engine ran EP islands {ep}")
    del eng, params
    _free()


def _tokens_dense_mesh(cfg, params, ctx, prompt, want) -> None:
    """fp32 Llama: ``prompt`` prefilled whole in zigzag order through the
    causal-skip ring on ``SP`` positions, its KV handed to dense caches
    split ``SP`` ways, then split-KV ticks (K4 a shard): the greedy tokens
    must be the unsharded dense path's and ``want``, the paged
    engine's."""
    from repro_torch.core.zigzag import zigzag_permutation
    from repro_torch.launch.mesh import make_context as mesh_context
    from repro_torch.launch.mesh import make_mesh
    L, ticks = len(prompt), len(want) - 1
    zz = mesh_context(make_mesh((SP,), ("data",), device="cuda"),
                      "prefill").with_(zigzag_skip=True)
    dec = mesh_context(make_mesh((1, SP), ("data", "model"), device="cuda"),
                       "decode")
    _reset_counts()
    mesh = [t[0] for t in _dense_run(
        cfg, params, zz, prompt, [L], ticks,
        positions=zigzag_permutation(L, SP), decode_ctx=dec,
        max_seq=-(-(L + ticks) // SP) * SP)["tokens"]]
    counts = _read_counts()
    _check_launches(counts, "sp_dense")
    flat = [t[0] for t in _dense_run(cfg, params, ctx, prompt, [L],
                                     ticks)["tokens"]]
    emit(phase="tokens", model=cfg.name, path="dense_zigzag_split_kv",
         launches=counts, mesh=mesh, dense=flat, paged=want,
         identical=mesh == flat == want)
    check(mesh == flat == want, "fp32 zigzag + split-KV dense tokens differ "
          "from the dense path's or the paged engine's")


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
    # the zigzag causal-skip ring and the split-KV dense ticks on the mesh
    # give the same tokens (the longest prompt: zigzag needs 2 SP slices)
    _tokens_dense_mesh(cfg, params, ctx, prompts[3], outs[3])
    del params
    _free()
    # the mesh engines of the other families: Mamba-2 (the 1024-token
    # chunks run sp_ssd, the others one scan) and Qwen1.5-MoE with expert
    # parallelism (the 2000-token chunks' and every tick's MoE layers take
    # EP)
    _tokens_mesh(*_tokens_engine("mamba2-1.3b", "serve_mamba", 2,
                                 (300, 1000, 2048, 4000), 8), 8,
                 "sp_mamba", _sp_context())
    _tokens_mesh(*_tokens_engine("qwen2-moe-a2.7b", "serve_moe", 3,
                                 (300, 1000, 2500, 4000), 8), 8,
                 "sp_moe", _sp_context().with_(moe_ep=True))
    _tokens_engine("chatglm3-6b", "serve_chatglm", 4,
                   (300, 1000, 2500, 4000), 8)
    _tokens_engine("nemotron-4-15b", "serve_nemotron", 5,
                   (300, 1000, 2500, 4000), 8)
    _tokens_whisper(6)
    # the rest of the registry.  Mixtral's trace holds a 5000-token prompt,
    # past its 4096-token window (its second chunk's history and its ticks
    # lose keys to the window); Jamba runs its published layers 3-4, a
    # Mamba layer with the MoE FFN and the attention layer (layers 0-4 are
    # 96 GB in fp32)
    for arch, path, seed, lens, kw in (
            ("yi-9b", "serve_yi", 7, (300, 1000, 2500, 4000), {}),
            ("phi4-mini-3.8b", "serve_phi", 8, (300, 1000, 2500, 4000), {}),
            ("llama3-70b", "serve_llama70b", 9, (300, 1000, 2500, 4000), {}),
            ("qwen2-vl-72b", "serve_qwen2vl", 10, (300, 1000, 2500, 4000),
             {}),
            ("mixtral-8x22b", "serve_mixtral", 11, (300, 1000, 2500, 5000),
             {"max_seq": 5120, "prefill_pool_blocks": 200}),
            ("jamba-1.5-large-398b", "serve_jamba", 12,
             (300, 1000, 2500, 4000), {"first": 3})):
        _tokens_engine(arch, path, seed, lens, 8, **kw)
        _free()


# ------------------------------------------------------------ phase train
# Llama-3-8B trains at published widths with its depth cut: AdamW's two
# fp32 moments for 8.03e9 parameters are 64 GB, with the bf16 weights and
# gradients 96 GB, more than the card's 80 GB
TRAIN_LLAMA_LAYERS, TRAIN_LLAMA_SEQ, TRAIN_LLAMA_STEPS = 4, 4096, 8
TRAIN_MAMBA_SEQ, TRAIN_MAMBA_STEPS = 2048, 4
TRAIN_OPT = dict(lr=1e-3, warmup_steps=4)
# the fp32 gradient check: two layers at full width, seq 1024
TRAIN_FP32_LAYERS, TRAIN_FP32_SEQ = 2, 1024
TRAIN_FP32_LOSS_RTOL, TRAIN_FP32_COS = 1e-4, 0.9999
# a bf16 step's loss on the kernel path against the plain path's,
# relative: the two trajectories part as training goes (Adam's updates
# follow the sign of gradients that bf16 rounding moves); measured 1.4e-4
# at worst over Llama's 8 steps and 3.4e-3 at Mamba-2's 4th step (NVIDIA
# H100 80GB HBM3, 700.00 W), so the limit is 6x the worst
TRAIN_BF16_LOSS_RTOL = 2e-2


def train_launches(cfg, steps: int, remat: bool) -> int:
    """K3 (or K5) launches of ``steps`` train steps: one a layer in the
    forward, and under remat one more in the backward's recompute (the
    backward itself differentiates the plain version)."""
    return cfg.n_layers * steps * (2 if remat else 1)


def _train_batch(cfg, seq: int, step: int, device) -> dict:
    """Batch ``step`` of the synthetic LM, one sequence, on ``device``."""
    import torch
    from repro_torch.training.data import make_pipeline
    return {k: torch.from_numpy(v.copy()).to(device)
            for k, v in make_pipeline(cfg, seq, 1).batch(step).items()}


@contextlib.contextmanager
def _backward_wrapped(fn, wrap):
    """Inside the block the autograd Function ``fn`` runs ``wrap(its
    backward)`` as its backward."""
    saved = fn.__dict__["backward"]
    fn.backward = staticmethod(wrap(saved.__func__))
    try:
        yield
    finally:
        fn.backward = saved


def _train_path(cfg, ctx, seq: int, steps: int):
    """``steps`` steps of ``Trainer`` on seeded weights and the synthetic
    LM's batches of one sequence: every step's loss, gnorm and ms, the
    tokens/s of the steps after the first, the peak memory and the
    kernels launched; and the trainer."""
    import torch
    from repro_torch.models.params import init_params
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import Trainer
    params = init_params(cfg, seed=0, device=ctx.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, params, ctx=ctx, opt=AdamW(**TRAIN_OPT))
    del params
    _reset_counts()
    hist = tr.fit(make_pipeline(cfg, seq, 1), steps, log_every=1)
    counts = _read_counts()
    walls = [0.0] + [r["wall"] for r in hist]
    step_ms = [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    out = {"loss": [r["loss"] for r in hist],
           "gnorm": [r["gnorm"] for r in hist], "step_ms": step_ms,
           "median_step_ms_after_first": steady,
           "tokens_per_s": seq / (steady / 1e3),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    return out, tr


def _train_split(tr, cfg, seq: int) -> dict:
    """Two more steps of ``tr`` (their updates dropped), each split on the
    card's stream by CUDA events into forward, backward and AdamW: one
    bare, one under torch.profiler, which gives the step's kernel time by
    group, its busy share, and the device time of the plain
    vector-Jacobian products that the autograd Functions' backward
    runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    from repro_torch.kernels.ssd_scan import SSDScanFn
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_loop import loss_fn
    batch = _train_batch(cfg, seq, 100, tr.ctx.device)

    def step() -> dict:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for _, p in tree_leaves(tr.params):
            p.grad = None
        torch.cuda.synchronize()
        ev[0].record()
        loss, _ = loss_fn(tr.params, cfg, tr.ctx, batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        tr.opt.update(tree_map(lambda p: p.grad, tr.params), tr.opt_state,
                      tr.params)
        ev[3].record()
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        return {"forward_ms": ms[0], "backward_ms": ms[1],
                "adamw_ms": ms[2], "step_ms": sum(ms)}

    def ranged(label):
        def wrap(backward):
            def run(*a):
                with record_function(label):
                    return backward(*a)
            return run
        return wrap

    bare = step()
    with _backward_wrapped(FlashAttentionFn, ranged("train/k3_plain_vjp")), \
            _backward_wrapped(SSDScanFn, ranged("train/k5_plain_vjp")):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled = step()
    groups, others = _kernel_groups(prof)
    vjp = {}
    for e in prof.key_averages():
        if e.device_type.name == "CPU" and e.key.startswith("train/"):
            vjp[e.key] = vjp.get(e.key, 0.0) + e.device_time_total / 1e3
    busy = sum(groups.values())
    return {"bare": bare, "profiled": profiled, "kernel_ms": groups,
            "busy_ms": busy, "idle_share": 1.0 - busy / profiled["step_ms"],
            "idle_share_bare": 1.0 - busy / bare["step_ms"],
            "plain_vjp_ms": vjp, "top_other_ms": others}


def _train_grads(cfg, ctx, seq: int, fault=None):
    """fp32 loss and gradients of one step (no update) from seeded
    weights; ``fault`` names an autograd Function whose first backward
    call (the last layer's) returns zero gradients."""
    import torch
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_loop import loss_fn, trainable
    params = trainable(init_params(cfg, seed=1, device=ctx.device))
    calls = []

    def zero_first(backward):
        def run(*a):
            out = backward(*a)
            calls.append(1)
            if len(calls) > 1:
                return out
            return tuple(None if t is None else torch.zeros_like(t)
                         for t in out)
        return run

    with (_backward_wrapped(fault, zero_first) if fault is not None
          else contextlib.nullcontext()):
        loss, _ = loss_fn(params, cfg, ctx, _train_batch(cfg, seq, 0,
                                                         ctx.device))
        loss.backward()
    return float(loss.detach()), dict(tree_leaves(
        tree_map(lambda p: p.grad, params)))


def _grad_agreement(got, want) -> dict:
    """Cosine of each gradient leaf with the plain path's, each layer of a
    stacked leaf on its own: the worst, and where."""
    import torch
    worst, where = 2.0, None
    for name, w in want.items():
        g = got[name]
        parts = (zip(g, w) if name.startswith(("blocks/", "encoder/"))
                 else ((g, w),))
        for i, (a, b) in enumerate(parts):
            a, b = a.flatten().double(), b.flatten().double()
            den = float(a.norm() * b.norm())
            cos = float(a @ b) / den if den else float(a.norm() == b.norm())
            if cos < worst:
                worst, where = cos, f"{name}[{i}]"
    return {"worst_cos": worst, "at": where}


def _train_fp32(arch: str, ctx, fn) -> dict:
    """The fp32 gate at full width, ``TRAIN_FP32_LAYERS`` layers and seq
    ``TRAIN_FP32_SEQ``: the kernel path's first-step loss within
    ``TRAIN_FP32_LOSS_RTOL`` of the plain path's and every gradient leaf
    (each layer) at cosine >= ``TRAIN_FP32_COS``; the same path with
    ``fn``'s backward zeroed for one layer must fail it."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=TRAIN_FP32_LAYERS,
                              dtype="float32")
    seq = TRAIN_FP32_SEQ
    l_p, g_p = _train_grads(cfg, ctx.with_(impl="ref"), seq)
    _reset_counts()
    l_k, g_k = _train_grads(cfg, ctx, seq)
    counts = _read_counts()
    kernel = "flash_attention" if cfg.ssm is None else "ssd_scan"
    check(counts[kernel] == train_launches(cfg, 1, ctx.remat),
          f"train: the fp32 {arch} step launched {counts}")
    right = _grad_agreement(g_k, g_p)
    right["loss_rel"] = abs(l_k - l_p) / abs(l_p)
    del g_k
    _free()
    l_f, g_f = _train_grads(cfg, ctx, seq, fault=fn)
    planted = _grad_agreement(g_f, g_p)
    planted["loss_rel"] = abs(l_f - l_p) / abs(l_p)
    del g_f, g_p
    _free()
    out = {"model": cfg.name, "layers": cfg.n_layers, "seq": seq,
           "remat": ctx.remat, "loss": l_k, "plain_loss": l_p,
           "launches": counts, "right": right,
           f"planted_{fn.__name__}_zeroed_one_layer": planted}
    emit(phase="train", check="fp32_gradients", **out)
    check(right["loss_rel"] <= TRAIN_FP32_LOSS_RTOL
          and right["worst_cos"] >= TRAIN_FP32_COS,
          f"train: fp32 {arch} gradients of the kernel path off the plain "
          f"path's: {right}")
    check(planted["worst_cos"] < TRAIN_FP32_COS,
          f"train: the fp32 gate missed {fn.__name__}'s zeroed gradient: "
          f"{planted}")
    return out


def _k3_train_times(cfg, S: int) -> dict:
    """K3 at the train shape (one sequence of ``S`` tokens, causal, bf16):
    forward, and forward + backward through ``FlashAttentionFn`` (the
    backward is the plain version's vector-Jacobian product), beside the
    plain version and ``scaled_dot_product_attention``, by CUDA events
    with the card busy; bounds at 3.35 TB/s and 989 TFLOP/s, the
    backward counted as twice the forward's products."""
    import torch
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     flash_attention,
                                                     flash_attention_plain)
    dev = torch.device("cuda")
    H, KVH, D = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim_
    gen = torch.Generator(device="cpu").manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    q, k, v = randn(1, S, H, D), randn(1, S, KVH, D), randn(1, S, KVH, D)
    go = randn(1, S, H, D)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    pairs = S * (S + 1) // 2
    fwd_b = ring_step_bound_ms(S, H, KVH, D, pairs)
    # fwd + bwd: q, k, v, o, dO read and dq, dk, dv written once; three
    # times the forward's products
    nbytes = (4 * S * H * D + 4 * S * KVH * D) * 2 + H * S * 4
    both_b = bound_ms(nbytes, 3 * 4 * H * D * pairs, "bfloat16")
    sdpa = _sdpa(q, k, v, None, causal=True)
    o, _ = flash_attention(q, k, v, pos, pos)
    po, _ = flash_attention_plain(q, k, v, pos, pos)
    tol = KERNEL_TOL["bfloat16"]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def k_both():
        out, _ = FlashAttentionFn.apply(*leaves, pos, pos, True, None, None)
        torch.autograd.grad(out, leaves, go)

    def p_both():
        out, _ = flash_attention_plain(*leaves, pos, pos)
        torch.autograd.grad(out, leaves, go)

    def l_both():
        # GQA without repeating K/V: the library's own grouped call
        out = torch.nn.functional.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in leaves), is_causal=True,
            enable_gqa=True)
        torch.autograd.grad(out, leaves, go.transpose(1, 2))

    return {"B": 1, "S": S, "H": H, "KVH": KVH, "D": D,
            "o_ratio": close_ratio(o, po, tol["atol"], tol["rtol"]),
            "forward": {"ms": event_ms(lambda: flash_attention(
                q, k, v, pos, pos), cold=False),
                "plain_ms": event_ms(lambda: flash_attention_plain(
                    q, k, v, pos, pos), cold=False, n=3),
                "library_ms": event_ms(sdpa, cold=False),
                "bound_ms": fwd_b[0], "bound_by": fwd_b[1]},
            "forward_backward": {"ms": event_ms(k_both, cold=False, n=3),
                                 "plain_ms": event_ms(p_both, cold=False,
                                                      n=3),
                                 "library_ms": event_ms(l_both, cold=False,
                                                        n=5),
                                 "bound_ms": both_b[0],
                                 "bound_by": both_b[1]}}


def _train_model(arch: str, cfg, ctx, seq: int, steps: int, path: str,
                 fn) -> dict:
    """The kernel path and the plain path of ``steps`` bf16 steps from the
    same seed; the gates of ``phase_train``.  Returns the kernel path's
    launch counts."""
    want = train_launches(cfg, steps, ctx.remat)
    runs, split = {}, None
    for impl in (None, "ref"):
        run, tr = _train_path(cfg, ctx.with_(impl=impl), seq, steps)
        if impl is None:
            split = _train_split(tr, cfg, seq)
        runs[impl or "cuda"] = run
        del tr
        _free()
    k, p = runs["cuda"], runs["ref"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k["loss"], p["loss"])]
    kernel = "flash_attention" if cfg.ssm is None else "ssd_scan"
    from repro_torch.launch import roofline
    from repro_torch.models.config import InputShape
    # the step's useful flops at its cut shape over its measured time
    mf = roofline.model_flops(cfg, InputShape(f"train_{seq}", seq, 1,
                                              "train"))
    emit(phase="train", model=cfg.name, layers=cfg.n_layers, seq=seq,
         batch=1, steps=steps, remat=ctx.remat, optimizer=TRAIN_OPT,
         kernel_path=k, plain_path=p, loss_rel_vs_plain=rel,
         launches_predicted={kernel: want}, step_split=split,
         model_flops=mf, mfu=mf / (k["median_step_ms_after_first"] / 1e3
                                   * roofline.PEAK_FLOPS))
    _check_launches(k["launches"], path)
    check(k["launches"][kernel] == want,
          f"train {arch}: {kernel} launched {k['launches'][kernel]}, "
          f"predicted {want}")
    check(not any(p["launches"].values()),
          f"train {arch}: the plain path launched kernels")
    check(all(map(math.isfinite, k["loss"] + p["loss"])),
          f"train {arch}: a loss is not finite")
    check(k["loss"][-1] < k["loss"][0],
          f"train {arch}: the loss did not decrease: {k['loss']}")
    check(max(rel) <= TRAIN_BF16_LOSS_RTOL,
          f"train {arch}: a step's loss is {max(rel)} off the plain path's")
    _train_fp32(arch, ctx, fn)
    return k["launches"]


def phase_train() -> dict:
    """The training path on the card, bf16 at published widths:
    Llama-3-8B cut to ``TRAIN_LLAMA_LAYERS`` layers (K3 through
    ``FlashAttentionFn``) and the whole Mamba-2-1.3B under remat (K5
    through ``SSDScanFn``, twice a layer a step), each on the kernel path
    and the plain path from one seed; then K3's times at the train
    shape.  Returns the kernel paths' launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    from repro_torch.kernels.ssd_scan import SSDScanFn
    from repro_torch.models.sharding import make_context
    ctx = make_context("cuda")
    full = get_config("llama3-8b")
    llama = dataclasses.replace(full, n_layers=TRAIN_LLAMA_LAYERS)
    emit(phase="train", model=full.name, cut={
        "n_layers": [full.n_layers, llama.n_layers],
        "why": "AdamW's two fp32 moments for 8.03e9 parameters are 64 GB; "
               "with bf16 weights and gradients 96 GB, above the card's "
               "80 GB"})
    out = {"train_llama": _train_model(
        "llama3-8b", llama, ctx, TRAIN_LLAMA_SEQ, TRAIN_LLAMA_STEPS,
        "train_llama", FlashAttentionFn)}
    out["train_mamba"] = _train_model(
        "mamba2-1.3b", get_config("mamba2-1.3b"), ctx.with_(remat=True),
        TRAIN_MAMBA_SEQ, TRAIN_MAMBA_STEPS, "train_mamba", SSDScanFn)
    times = _k3_train_times(full, TRAIN_LLAMA_SEQ)
    emit(phase="train", k3_train_shape=times)
    check(times["o_ratio"] <= 1.0,
          f"train: K3 at the train shape disagrees: {times['o_ratio']}")
    _free()
    return out


# ------------------------------------------------------- phase 8: roofline
ROOFLINE_BUDGET_S = 90
# the reference's step shapes on one card: (arch, shape, variant, batch on
# the card, why the reference's global batch was cut, kernel launches a
# step); the plain path each step's logits are held to
ROOFLINE_STEPS = (
    ("llama3-8b", "prefill_32k", "", 1,
     "32 sequences of 32768 tokens: 16 GB of weights beside 32 x 4.3 GB "
     "of KV written by the step; one sequence's layer activations (an "
     "FFN intermediate is 0.94 GB) set the peak",
     {"flash_attention": 32}, "ref_blocked"),
    ("llama3-8b", "decode_32k", "", 8,
     "128 x 32768 x 131,072 B = 550 GB of KV; 8 sequences hold 34.4 GB "
     "beside 16 GB of weights", {"flash_decode": 32}, "ref"),
    ("llama3-8b", "long_500k", "ring_cache", 1, None,
     {"flash_decode": 32}, "ref"),
    ("mamba2-1.3b", "prefill_32k", "", 1,
     "32 sequences cut to 1, as Llama's", {"ssd_scan": 48}, "ref"),
    ("mamba2-1.3b", "long_500k", "", 1, None, {}, None),
)


def _roofline_gate(cfg, want: dict):
    """``attn_call_gate``'s plan for a roofline step of an attention
    model, or None: the first and the last layer's K3 calls held to
    ``ref_blocked`` (a 32k-token prefill's whole score matrix would not
    fit), every K4 call to its plain version; V one key off and the
    second half of the keys dropped planted in the first and the last
    layer's calls.  At 32,768 random keys a layer's attention output is a
    few hundredths, so the logits alone cannot see a wrong K3 or K4."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import _zero_dead_rows
    ends = (0, cfg.n_layers - 1)
    faults = tuple(ATTN_FAULTS)
    if "flash_attention" in want:
        def k3_blocked(q, k, v, q_pos, kv_pos, **kw):
            o, lse = ref.attention_ref_blocked(q, k, v, q_pos, kv_pos,
                                               with_lse=True, **kw)
            return _zero_dead_rows(o, lse), lse
        return (want, {"flash_attention": ends},
                dict(held={"flash_attention": ends},
                     plain_fns={"flash_attention": k3_blocked},
                     faults=faults))
    if "flash_decode" in want:
        return want, {"flash_decode": ends}, dict(faults=faults)
    return None


def _roofline_step(arch, sn, variant, batch, why, want, plain) -> dict:
    """One step of ``launch.steps.build_step`` on the card at ``batch``
    sequences: the dry run's counts of the same cut shape on the meta
    device, the bytes the card holds before the step beside the dry
    run's argument bytes, the launches of one run, the median of three
    warm runs by CUDA events, the peak beside the dry run's, the roofline
    terms on the H100's peaks and ``mfu``; one more kernel-path run with
    its attention calls held per call (``_roofline_gate``); the logits
    held to ``plain``'s (None: the step has no kernel).  Returns the
    step's launch counts."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, data_values, make_args
    from repro_torch.models.config import INPUT_SHAPES
    t0 = time.time()
    cfg = get_config(arch)
    full = INPUT_SHAPES[sn]
    shape = dataclasses.replace(full, global_batch=batch)
    ov = dryrun.VARIANTS[variant]
    axes = ("data", "model")
    dry = dryrun.step_record(cfg, shape, make_mesh((1, 1), axes, "meta"), ov)
    t_dry = time.time() - t0
    mesh = make_mesh((1, 1), axes, "cuda")
    _free()
    base = torch.cuda.memory_allocated()
    fn, place, abstract = build_step(cfg, shape, mesh, ctx_overrides=ov)
    args, _ = make_args(cfg, shape, abstract, place, mesh, seed=0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        _reset_counts()
        logits, caches = fn(*args)
        torch.cuda.synchronize()
        counts = _read_counts()
        del caches
        ms = []
        for _ in range(3):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated() - base
    t_run = time.time() - t0 - t_dry
    step_ms = sorted(ms)[1]
    mf = roofline.model_flops(cfg, shape)
    roof = roofline.analyse(arch, shape, "1x1", 1, cfg,
                            {"flops": dry["flops"],
                             "bytes accessed": dry["bytes accessed"]},
                            peak_mem=dry["argument_bytes"]
                            + dry["temp_bytes"])
    # the least time of the step: its useful flops at the peak, or its
    # arguments (weights, caches) read once at the HBM rate
    least_ms = 1e3 * max(mf / roofline.PEAK_FLOPS,
                         dry["argument_bytes"] / roofline.HBM_BW)
    rec = dict(
        phase="roofline", model=cfg.name, step=sn, variant=variant,
        batch={"reference": full.global_batch, "card": batch, "why": why},
        seq_len=shape.seq_len, data_values=data_values(shape),
        device_ms={"median_of_3": step_ms, "runs": ms},
        model_flops=mf, counted={
            "flops": dry["flops"], "bytes": dry["bytes accessed"],
            "path": f"impl={dryrun.COUNTED_IMPL!r}, unfused aten ops"},
        roofline_s={"compute": roof.compute_s, "memory": roof.memory_s,
                    "memory_adj": roof.memory_adj_s},
        bottleneck=roof.bottleneck, bottleneck_counted=roof.bottleneck_hlo,
        useful_ratio=roof.useful_ratio, least_ms=least_ms,
        share_of_least=least_ms / step_ms,
        mfu=mf / (step_ms / 1e3 * roofline.PEAK_FLOPS),
        bytes_held={"card": held, "dry_run_arguments":
                    dry["argument_bytes"],
                    "rel": held / dry["argument_bytes"] - 1},
        peak_bytes={"card_above_start": peak, "dry_run_arguments_plus_temp":
                    dry["argument_bytes"] + dry["temp_bytes"]},
        launches=counts, launches_predicted=want,
        seconds={"dry_run": t_dry, "card": t_run})
    check(all(counts[k] == n for k, n in want.items())
          and not any(c for k, c in counts.items() if k not in want),
          f"roofline {arch} {sn}: launches {counts}, predicted {want}")
    check(abs(held / dry["argument_bytes"] - 1) <= 0.01,
          f"roofline {arch} {sn}: the card holds {held} B before the "
          f"step, the dry run places {dry['argument_bytes']} B")
    lg = logits.float().reshape(-1, logits.shape[-1])
    check(tuple(logits.shape) == (batch, 1, cfg.padded_vocab)
          and bool(torch.isfinite(lg).all()),
          f"roofline {arch} {sn}: logits {tuple(logits.shape)} not finite "
          "or of the wrong shape")
    plan = _roofline_gate(cfg, want)
    gate = None
    if plan is not None:
        t1 = time.time()
        with torch.no_grad():
            _, gate = attn_call_gate(lambda: fn(*args), *plan[:2], **plan[2])
            torch.cuda.synchronize()
        rec["call_gate"] = gate
        rec["seconds"]["gate"] = time.time() - t1
    if plain is not None:
        t1 = time.time()
        fp, _, _ = build_step(cfg, shape, mesh, impl=plain,
                              ctx_overrides=ov)
        with torch.no_grad():
            _reset_counts()
            want_logits, _ = fp(*args)
            torch.cuda.synchronize()
            check(not any(_read_counts().values()),
                  f"roofline {arch} {sn}: the plain path launched kernels")
        rec["seconds"]["plain"] = time.time() - t1
        emit(**rec)
        wl = want_logits.float().reshape(-1, logits.shape[-1])
        _logits_vs_plain(f"roofline {cfg.name} {sn} vs impl={plain}",
                         [f"row{i}" for i in range(len(lg))], list(lg),
                         list(wl), LOGIT_TOL[arch])
        del want_logits
    else:
        emit(**rec)
    check(gate is None or gate["ok"],
          f"roofline {arch} {sn}: an attention call disagrees with its "
          "plain version, or a planted fault passed")
    del args, logits
    _free()
    return counts


def phase_roofline() -> dict:
    """The reference's step shapes (``launch/steps.build_step``) on the
    card at published widths, each global batch cut to fit 80 GB:
    Llama-3-8B's prefill_32k (K3 over 32768 causal keys a layer),
    decode_32k (K4 a layer) and long_500k under ``ring_cache`` (K4 over
    the 4096-token window at position 524,287), Mamba-2-1.3B's
    prefill_32k (K5 a layer) and long_500k (the one-token SSD step is
    plain, as in the reference).  Each step's time, counts and roofline
    terms (``_roofline_step``); Llama's logits and Mamba's prefill's are
    held to the plain path's.  Returns the launch counts by path."""
    t0 = time.time()
    emit(phase="roofline", budget_s=ROOFLINE_BUDGET_S,
         steps=[s[:4] for s in ROOFLINE_STEPS])
    out = {"roofline_llama": {}, "roofline_mamba": {}}
    for step in ROOFLINE_STEPS:
        counts = _roofline_step(*step)
        path = "roofline_llama" if step[0] == "llama3-8b" \
            else "roofline_mamba"
        for k, c in counts.items():
            out[path][k] = out[path].get(k, 0) + c
    for path, counts in out.items():
        _check_launches(counts, path)
    emit(phase="roofline", seconds=time.time() - t0,
         budget_s=ROOFLINE_BUDGET_S)
    return out


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
                             "serve_elastic", "serve_tiers", "sp_families",
                             "dense", "whisper", "tokens", "train",
                             "roofline", "profile"])
    args = ap.parse_args(argv)
    phases = args.only or ["device", "kernels", "serve", "serve_sp",
                           "serve_elastic", "serve_tiers", "sp_families",
                           "dense", "whisper", "tokens", "train",
                           "roofline"]

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.time()
    seconds = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        seconds[name] = time.time() - t0
        return out

    smi = timed("device", phase_device)
    rows = timed("kernels", phase_kernels) if "kernels" in phases else {}
    by_path = timed("serve", phase_serve) if "serve" in phases else {}
    if "serve_sp" in phases:
        by_path["serve_sp"] = timed("serve_sp", phase_serve_sp)
    for name, fn in (("serve_elastic", phase_serve_elastic),
                     ("serve_tiers", phase_serve_tiers),
                     ("sp_families", phase_sp_families)):
        if name in phases:
            by_path.update(timed(name, fn))
    if "dense" in phases:
        by_path["dense"] = timed("dense", phase_dense)
    if "whisper" in phases:
        by_path["whisper"] = timed("whisper", phase_whisper)
    if "tokens" in phases:
        timed("tokens", phase_tokens)
    for name, fn in (("train", phase_train), ("roofline", phase_roofline)):
        if name in phases:
            by_path.update(timed(name, fn))
    if "profile" in phases:
        timed("profile", phase_profile)
    emit(phase="smoke", seconds_by_phase=seconds,
         seconds=time.time() - t_start)
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
