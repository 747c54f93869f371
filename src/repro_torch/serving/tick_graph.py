"""CUDA graphs of the serving engine's decode tick.

A decode tick of the single-device engine launches a few thousand small
kernels (K1, the cuBLAS products and the elementwise chain of every
layer, then the argmax), and on the card the host's launches, not the
kernels, set the tick's time.  ``TickGraphs`` captures the tick's forward
and argmax once per shape and replays the graph every tick after; every
kernel in the graph is the one the uncaptured tick launches.

What the capture needs, and where it comes from:

* static inputs — the tokens (B, 1), the cache lengths (B,) and the block
  table live in persistent device buffers, which each tick fills from
  page-locked host memory without waiting for the card (``stage``);
  positions (M-RoPE's (3, B, 1) included) are derived from the lengths
  inside the graph, and the argmax writes the graph's static (B,) output;
* a table width from a small set (``table_width``): K1's split count
  follows the table's width, so a graph is captured per width, lazily on
  the first tick at that width; padded columns point at the scratch page
  and are masked by length, as idle rows already are;
* Mamba-2's state in one batched pair of buffers per instance
  (``PagedDecodeState``): the graph reads one and writes the other, and
  ``absorb`` flips which is current, so a graph is captured per width
  and per current buffer.

All graphs of an instance share one memory pool.  The instance's first
tick runs uncaptured on the capture stream, so whatever the kernels,
cuBLAS and the caching allocator set up on first use is set up outside
any capture.  Which ticks may be captured is decided from the layout
(``graph_eligible``) by the engine.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 paged_flash_prefill)
from repro_torch.kernels.flash_decode import flash_decode, paged_flash_decode
from repro_torch.kernels.ssd_scan import ssd_scan

# the hand-written kernels' launch counters: a capture launches nothing,
# and each replay launches what its capture recorded
_COUNTED = (flash_attention, paged_flash_prefill, paged_flash_decode,
            flash_decode, ssd_scan)

MIN_WIDTH = 16      # pages: the narrowest table a graph is captured for


def table_width(n_pages: int) -> int:
    """The block table's width for a batch whose longest allocation is
    ``n_pages``: at least ``MIN_WIDTH``, else rounded up to half of the
    power of two at or above ``n_pages`` (16, 24, 32, 48, 64, 96, 128,
    192, ...), so a table is padded by under a third of its width and two
    graphs cover each doubling of the length.  Each width is a capture
    in the window it first appears in; a quarter of the power of two
    doubled the captures of a Yi-9B window (8 to 14) to save K1 about 7%
    a call."""
    if n_pages <= MIN_WIDTH:
        return MIN_WIDTH
    step = 1 << ((n_pages - 1).bit_length() - 2)
    return -(-n_pages // step) * step


def graph_eligible(cfg, ctx, kv_shards: int) -> bool:
    """Whether an engine's decode tick can be captured: the kernels on a
    CUDA device (``impl`` None), no mesh and no ring or split axis, every
    attention layer paged with a 2-dim table (an unsharded pool), and no
    cross-attention layer (whose decode reads a dense cross cache)."""
    return (torch.device(ctx.device).type == "cuda" and ctx.impl is None
            and ctx.mesh is None and ctx.sp_axis is None
            and ctx.kv_split_axis is None and kv_shards == 1
            and not any(s.cross_attn for s in cfg.pattern))


@dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor            # (B,) the argmax, the graph's output
    caches: dict                    # the forward's cache tree
    launches: Tuple[int, ...]       # per counted kernel, each replay


class TickGraphs:
    """One decode instance's static tick inputs and its captured ticks."""

    def __init__(self, max_batch: int, device, metrics):
        self.device = torch.device(device)
        self.metrics = metrics
        B = max_batch
        self.tokens = torch.zeros((B, 1), dtype=torch.int32,
                                  device=self.device)
        self.lengths = torch.zeros((B,), dtype=torch.int32,
                                   device=self.device)
        self._host = (torch.zeros((B, 1), dtype=torch.int32).pin_memory(),
                      torch.zeros((B,), dtype=torch.int32).pin_memory())
        self._tables: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def stage(self, tokens: np.ndarray, lengths: np.ndarray,
              table: Optional[np.ndarray]):
        """Copy a tick's inputs into the static buffers through page-locked
        memory, without waiting for the card (the previous tick's readback
        waited for the previous copies).  Returns the static tokens,
        lengths and table (None for a model without attention layers)."""
        h_tok, h_len = self._host
        h_tok.numpy()[...] = tokens
        h_len.numpy()[...] = lengths
        self.tokens.copy_(h_tok, non_blocking=True)
        self.lengths.copy_(h_len, non_blocking=True)
        if table is None:
            return self.tokens, self.lengths, None
        width = table.shape[1]
        if width not in self._tables:
            self._tables[width] = (
                torch.empty(table.shape, dtype=torch.int32).pin_memory(),
                torch.empty(table.shape, dtype=torch.int32,
                            device=self.device))
        h_bt, bt = self._tables[width]
        h_bt.numpy()[...] = table
        bt.copy_(h_bt, non_blocking=True)
        return self.tokens, self.lengths, bt

    def run(self, key, step: Callable[[], Tuple[torch.Tensor, dict]]
            ) -> Tuple[torch.Tensor, dict, bool]:
        """The tick ``step`` (returning the argmax and the forward's
        caches) on the static inputs: replayed from the graph of ``key``,
        captured first if there is none.  The instance's first tick runs
        ``step`` itself on the capture stream instead.  Returns (tokens,
        caches, whether a graph was replayed)."""
        cur = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                tokens, caches = step()
            cur.wait_stream(self._stream)
            return tokens, caches, False
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(step)
            self.metrics.counter("tick/graph_captures").inc()
        g.graph.replay()
        for fn, n in zip(_COUNTED, g.launches):
            fn.launches += n
        return g.tokens, g.caches, True

    def _capture(self, step) -> _Graph:
        before = [fn.launches for fn in _COUNTED]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        # a collection inside the capture may destroy another graph, a
        # CUDA call that invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool)
                try:
                    tokens, caches = step()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(self._stream)
        launches = tuple(fn.launches - b for fn, b in zip(_COUNTED, before))
        for fn, b in zip(_COUNTED, before):
            fn.launches = b
        return _Graph(graph, tokens, caches, launches)
