"""Handshake-based CDSP cache-transfer management (Sec. 4.2).

With CDSP, one request's KV chunks live on *multiple* prefill instance
groups; the decode side can only start once every chunk has arrived, and
transfer backends (buffer-backed channels) are scarce.  The manager
implements the paper's handshake protocol: a send manager announces each
chunk; if the receive engine has a free backend the transfer launches
immediately, otherwise requests are ordered by FIRST handshake timestamp and
backends are dedicated to one request until all of its chunks have landed —
preventing backend starvation from stranding partially-transferred caches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class _ReqState:
    first_handshake: float
    pending_chunks: List[Tuple[int, float]] = field(default_factory=list)
    chunks_left: int = 0
    backend: Optional[int] = None


class TransferManager:
    """Receive-side manager for one decode instance."""

    @staticmethod
    def paged_chunk_bytes(chunk_lens: List[int], block_size: int,
                          kv_bytes_per_token: float) -> List[float]:
        """Per-chunk wire sizes for the paged KV handoff.

        With prefill-direct-to-pages the unit of transfer is the physical
        page, so each chunk ships the pages whose content it *finalised*
        — ``floor(cum/bs) - floor(prev_cum/bs)`` whole pages (a page
        cannot move before its last token lands) — rather than its
        dense-equivalent ``len * kv_bytes_per_token``.  The trailing
        partial page rides with the last chunk.  Totals equal the
        request's page footprint (``blocks_for(sum) * block_size *
        kv_bytes_per_token``) and the number of ``chunk_landed`` events is
        unchanged — one per chunk, even when a chunk finalises no page."""
        page_b = block_size * kv_bytes_per_token
        out, pages_done, cum = [], 0, 0
        for L in chunk_lens:
            cum += L
            pages = cum // block_size
            out.append((pages - pages_done) * page_b)
            pages_done = pages
        if chunk_lens and cum % block_size:
            out[-1] += page_b                  # trailing partial page
        return out

    @staticmethod
    def swap_bytes(n_blocks: int, block_size: int,
                   kv_bytes_per_token: float) -> float:
        """Wire bytes of ``n_blocks`` whole pages crossing PCIe, one
        direction — the unit of the host offload tier's swap-out/swap-in
        and demote/promote moves (page-granular, like the NIC handoff)."""
        return n_blocks * block_size * kv_bytes_per_token

    def __init__(self, n_backends: int, bandwidth: float = 40e9):
        self.n_backends = n_backends
        self.bandwidth = bandwidth
        self.free_backends = list(range(n_backends))
        self.states: Dict[int, _ReqState] = {}
        self.waiting: List[int] = []          # rids ordered by 1st handshake
        self.active: Dict[int, int] = {}      # backend -> rid
        self.completed: List[int] = []
        self.stats = {"handshakes": 0, "queued": 0, "transfers": 0,
                      # host offload tier PCIe traffic (bytes + moves):
                      # out/in = swap preemption round trips, demote =
                      # released hash blocks entering the host prefix
                      # cache, promote = admission cache hits copied back
                      "swap_out_bytes": 0.0, "swap_in_bytes": 0.0,
                      "demote_bytes": 0.0, "promote_bytes": 0.0,
                      "swaps_out": 0, "swaps_in": 0,
                      "demotes": 0, "promotes": 0,
                      # cluster KV fabric interconnect traffic: placed =
                      # swap victim's pages landing on a non-origin
                      # instance, peer_promote = a peer-resident prefix
                      # chain copied across instances, lease = the
                      # borrow/lend control handshake
                      "ic_placed_bytes": 0.0, "ic_peer_promote_bytes": 0.0,
                      "ic_lease_bytes": 0.0,
                      "ic_placed_moves": 0, "ic_peer_promote_moves": 0,
                      "ic_lease_moves": 0}
        self._metrics = None
        self._mprefix = ""

    def bind_metrics(self, metrics, prefix: str = "") -> None:
        """Mirror PCIe swap traffic into a telemetry ``MetricsRegistry``:
        ``note_swap`` additionally bumps ``<prefix>pcie_<dir>_bytes`` /
        ``<prefix>pcie_<dir>_moves`` counters."""
        self._metrics = metrics
        self._mprefix = prefix

    # ------------------------------------------------------- host offload
    def note_swap(self, direction: str, n_bytes: float) -> None:
        """Account one PCIe move of the host offload tier.  ``direction``
        is ``"out"``/``"in"`` (swap preemption) or ``"demote"``/
        ``"promote"`` (second-tier prefix cache); modeled as fully
        overlapped with decode ticks, so only the bytes are recorded —
        the swap *latency* lives on the engine's event clock."""
        key = {"out": ("swap_out_bytes", "swaps_out"),
               "in": ("swap_in_bytes", "swaps_in"),
               "demote": ("demote_bytes", "demotes"),
               "promote": ("promote_bytes", "promotes")}[direction]
        self.stats[key[0]] += n_bytes
        self.stats[key[1]] += 1
        if self._metrics is not None:
            p = self._mprefix
            self._metrics.counter(f"{p}pcie_{direction}_bytes").inc(n_bytes)
            self._metrics.counter(f"{p}pcie_{direction}_moves").inc()

    def note_interconnect(self, direction: str, n_bytes: float) -> None:
        """Account one device-to-device interconnect move of the cluster
        KV fabric.  ``direction`` is ``"placed"`` (swap victim resuming
        on a non-origin instance), ``"peer_promote"`` (a peer-resident
        prefix chain copied into this pool) or ``"lease"`` (page
        borrow/lend handshake traffic).  Like ``note_swap``, only the
        bytes are recorded — the transfer *latency* lives on the
        engine's event clock via ``InterconnectModel``."""
        key = {"placed": ("ic_placed_bytes", "ic_placed_moves"),
               "peer_promote": ("ic_peer_promote_bytes",
                                "ic_peer_promote_moves"),
               "lease": ("ic_lease_bytes", "ic_lease_moves")}[direction]
        self.stats[key[0]] += n_bytes
        self.stats[key[1]] += 1
        if self._metrics is not None:
            p = self._mprefix
            self._metrics.counter(f"{p}ic_{direction}_bytes").inc(n_bytes)
            self._metrics.counter(f"{p}ic_{direction}_moves").inc()

    # ---------------------------------------------------------- handshake
    def handshake(self, rid: int, n_chunks: int, chunk_bytes: List[float],
                  now: float) -> None:
        """Prefill side announces a request's chunk set."""
        self.stats["handshakes"] += 1
        st = self.states.get(rid)
        if st is None:
            st = _ReqState(first_handshake=now, chunks_left=n_chunks)
            st.pending_chunks = [(i, b) for i, b in enumerate(chunk_bytes)]
            self.states[rid] = st
            if self.free_backends:
                st.backend = self.free_backends.pop()
                self.active[st.backend] = rid
            else:
                self.stats["queued"] += 1
                self.waiting.append(rid)
                self.waiting.sort(key=lambda r: self.states[r].first_handshake)

    # ------------------------------------------------------------ service
    def transfer_time(self, rid: int) -> float:
        """Total wire time for the request's remaining chunks."""
        st = self.states[rid]
        return sum(b for _, b in st.pending_chunks) / self.bandwidth

    def chunk_landed(self, rid: int) -> bool:
        """One of ``rid``'s chunks finished its wire transfer; returns True
        when the whole cache has landed (decode may start)."""
        st = self.states[rid]
        if st.pending_chunks:
            st.pending_chunks.pop(0)
        st.chunks_left -= 1
        return st.chunks_left <= 0

    def complete(self, rid: int) -> None:
        """All chunks of ``rid`` have landed; recycle its backend in
        first-handshake order."""
        st = self.states.pop(rid)
        self.completed.append(rid)
        self.stats["transfers"] += 1
        if st.backend is not None:
            if self.waiting:
                nxt = self.waiting.pop(0)
                self.states[nxt].backend = st.backend
                self.active[st.backend] = nxt
            else:
                self.active.pop(st.backend, None)
                self.free_backends.append(st.backend)

    def has_backend(self, rid: int) -> bool:
        st = self.states.get(rid)
        return st is not None and st.backend is not None
