"""Prefill/decode latency models (paper Eq. 1) + least-squares fitting.

    T_s(R) = a_s + b_s * L + c_s * (C * L) + d_s * L^2          (Eq. 1)

where L = tokens in the chunk, C = historical tokens, s = SP size.
Two calibrations ship:

* ``table1_model()`` — fit to the paper's own Table 1 (LLaMA3-8B, A100,
  C=0 single-chunk measurements).  This is the *faithful* reproduction used
  to validate the scheduler against the paper's numbers.  The cross term is
  set ``c_s = 2 * d_s`` — intra-chunk causal attention does half the
  pair-work of chunk-vs-history attention, so the per-pair coefficient is
  exactly twice the (causal) quadratic one.
* ``analytic_model(cfg, ...)`` — derived from hardware peaks (defaults: TPU
  v5e, 197 TFLOP/s bf16, MFU ~0.45) for any ModelConfig; the TPU-native
  deployment path.  For SSM-dominated stacks the quadratic terms vanish and
  the model degrades gracefully to linear (DESIGN.md §Arch-applicability).

Decode latency model for the simulator: per-(SP, TP) multipliers calibrated
to the paper's Fig. 2 measurements.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

# --- paper Table 1: LLaMA3-8B prefill latency (s) on A100, TP=1 ------------
TABLE1_LENGTHS = np.array([4, 8, 16, 32, 64, 128, 256]) * 1024
TABLE1_LATENCY = {
    1:  [0.28, 0.57, 1.29, 3.22, 9.05, 29.20, None],
    2:  [0.16, 0.31, 0.69, 1.67, 4.61, 14.30, 50.07],
    4:  [0.13, 0.20, 0.39, 0.92, 2.43, 7.32, 24.77],
    8:  [0.21, 0.24, 0.31, 0.58, 1.37, 3.96, 12.81],
    16: [0.39, 0.43, 0.46, 0.53, 0.96, 2.31, 7.02],
}


@dataclass(frozen=True)
class SPCoeffs:
    a: float   # constant overhead (s)
    b: float   # per-token FC cost (s/token)
    c: float   # chunk-vs-history attention (s/token^2)
    d: float   # intra-chunk causal attention (s/token^2)

    def latency(self, C: float, L: float) -> float:
        return self.a + self.b * L + self.c * C * L + self.d * L * L

    def solve_chunk_len(self, C: float, budget: float) -> float:
        """Largest L with latency(C, L) <= budget (Alg. 3's model solve).

        Eq. (1) is quadratic in L, so the 'numerical solve' of the paper is
        closed-form here."""
        if budget <= self.a:
            return 0.0
        bb = self.b + self.c * C
        cc = self.a - budget
        if self.d <= 1e-18:
            return max(0.0, -cc / max(bb, 1e-18))
        disc = bb * bb - 4.0 * self.d * cc
        return max(0.0, (-bb + np.sqrt(disc)) / (2.0 * self.d))


class PrefillLatencyModel:
    """Eq. (1) per SP size."""

    def __init__(self, coeffs: Dict[int, SPCoeffs]):
        self.coeffs = dict(sorted(coeffs.items()))

    @property
    def sp_sizes(self) -> Tuple[int, ...]:
        return tuple(self.coeffs)

    def latency(self, sp: int, C: float, L: float) -> float:
        return self.coeffs[sp].latency(C, L)

    def solve_chunk_len(self, sp: int, C: float, budget: float) -> float:
        return self.coeffs[sp].solve_chunk_len(C, budget)

    def optimal_sp(self, L: float, C: float = 0.0) -> int:
        return min(self.coeffs, key=lambda s: self.latency(s, C, L))

    # ------------------------------------------------------------- fitting
    @staticmethod
    def fit(samples: Dict[int, Iterable[Tuple[float, float, float]]]
            ) -> "PrefillLatencyModel":
        """samples[s] = [(C, L, latency_seconds), ...] -> least squares fit
        with non-negativity enforced by coordinate clipping + refit."""
        coeffs = {}
        for s, rows in samples.items():
            rows = [r for r in rows if r[2] is not None]
            A = np.array([[1.0, L, C * L, L * L] for C, L, _ in rows])
            y = np.array([t for _, _, t in rows])
            active = [0, 1, 2, 3]
            # drop degenerate columns (e.g. all C == 0 -> c unidentifiable)
            for j in (2,):
                if np.allclose(A[:, j], 0):
                    active.remove(j)
            x = np.zeros(4)
            for _ in range(4):
                sol, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
                x[:] = 0
                x[active] = sol
                neg = [j for j in active if x[j] < 0]
                if not neg:
                    break
                for j in neg:
                    active.remove(j)
                x[:] = 0
            coeffs[s] = SPCoeffs(*x)
        return PrefillLatencyModel(coeffs)


def table1_model() -> PrefillLatencyModel:
    """The paper-faithful calibration (LLaMA3-8B / A100 / Table 1)."""
    samples = {
        s: [(0.0, float(L), t)
            for L, t in zip(TABLE1_LENGTHS, lat) if t is not None]
        for s, lat in TABLE1_LATENCY.items()}
    m = PrefillLatencyModel.fit(samples)
    # identify c from d (see module docstring)
    return PrefillLatencyModel({
        s: dataclasses.replace(co, c=2.0 * co.d) for s, co in m.coeffs.items()})


# --------------------------------------------------------------- analytic
TPU_V5E = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
A100 = dict(peak_flops=312e12, hbm_bw=2039e9, ici_bw=300e9)


def analytic_model(n_params_active: float, n_layers: int, d_model: int,
                   sp_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
                   *, hw: Optional[dict] = None, mfu: float = 0.45,
                   tp: int = 1, quadratic_frac: float = 1.0,
                   base_overhead: float = 5e-3,
                   ring_step_overhead: float = 3e-4) -> PrefillLatencyModel:
    """Roofline-derived Eq. (1) coefficients for any architecture.

    quadratic_frac: fraction of layers with (full) attention — 0 for pure
    SSM (linear model), 1/8 for Jamba, 1 for dense.  SWA models use the
    window as an effective cap handled by the scheduler, not here.
    """
    hw = hw or TPU_V5E
    eff = hw["peak_flops"] * mfu
    coeffs = {}
    for s in sp_sizes:
        chips = s * tp
        b = 2.0 * n_params_active / (eff * chips)
        # attention pair-work: 4 * d_model FLOPs per (q, kv) pair per layer
        pair = 4.0 * d_model * n_layers * quadratic_frac / (eff * chips)
        a = base_overhead + ring_step_overhead * s
        coeffs[s] = SPCoeffs(a=a, b=b, c=pair, d=pair / 2.0)
    return PrefillLatencyModel(coeffs)


# ------------------------------------------------------------- host offload
@dataclass(frozen=True)
class HostOffloadModel:
    """PCIe cost model for device<->host KV block movement (swap tier).

    Swap-to-host preemption (Infinite-LLM's memory tiering, LoongServe's
    proactive KV migration) trades a PCIe round trip for the re-prefill
    FLOPs that recompute preemption burns.  The engine's ``auto`` policy
    compares ``swap_time`` of a victim's resident pages against the
    prefill model's latency for its resume sequence — the PCIe term is
    the only new hardware constant.  Defaults are PCIe gen4 x16 with a
    conservative effective bandwidth and a per-transfer launch overhead
    (DMA setup + pinned-buffer staging).
    """
    pcie_bw: float = 24e9        # bytes/s, effective device<->host
    base: float = 2e-4           # s per transfer (DMA launch/staging)

    def swap_time(self, n_bytes: float) -> float:
        """Seconds to move ``n_bytes`` of KV across PCIe, one direction."""
        return self.base + n_bytes / self.pcie_bw


@dataclass(frozen=True)
class InterconnectModel:
    """Device-to-device interconnect cost model for cross-instance KV
    block movement (the cluster KV fabric tier, serving/kv_fabric.py).

    Where ``HostOffloadModel`` prices the PCIe hop to host memory, this
    prices the direct accelerator interconnect between two decode
    instances — ICI on TPU pods, NVLink/IB on GPU clusters.  The fabric
    adds this term whenever KV pages cross an instance boundary: a swap
    victim resuming on a non-origin instance, a peer-resident prefix
    chain promoted into another pool's pages.  Defaults are TPU v5e ICI
    effective bandwidth with a small per-transfer launch cost (collective
    setup), deliberately cheaper than the PCIe hop so placement prefers
    staying on-fabric over bouncing through the host.
    """
    link_bw: float = 50e9        # bytes/s, effective device<->device
    base: float = 5e-5           # s per transfer (collective launch)

    def transfer_time(self, n_bytes: float) -> float:
        """Seconds to move ``n_bytes`` of KV across the interconnect."""
        return self.base + n_bytes / self.link_bw


# ------------------------------------------------------------------ decode
# Fig. 2 calibration: decode step latency multipliers vs (SP1, TP8).
FIG2_TP_MULT = {8: 1.0, 4: 1.93, 2: 3.87, 1: 5.73}       # Fig. 2-(a)
FIG2_SP_MULT = {(1, 8): 1.0, (2, 4): 1.15, (4, 2): 1.41, (8, 1): 1.83}


@dataclass(frozen=True)
class DecodeLatencyModel:
    """TBT model: T = mult(sp, tp) * (base + w_cache * cache_tokens
    + w_batch * batch_tokens), calibrated per GPU budget of sp*tp chips.

    ``piggyback_factor`` is the mixed-step term: the fraction of the
    *marginal* tick cost a decode tick pays when it is fused into a
    co-resident prefill chunk step (Sarathi-style piggybacking,
    serving/engine.py).  The chunk's compute already streams the model
    weights and pays the kernel-launch overhead, so a piggybacked tick
    rides the chunk's slack instead of serializing a full step."""
    base: float = 8e-3
    w_cache: float = 1.2e-9      # s per cached token per chip-normalised
    w_batch: float = 1.5e-5
    piggyback_factor: float = 0.35

    def mult(self, sp: int, tp: int) -> float:
        if (sp, tp) in FIG2_SP_MULT:
            return FIG2_SP_MULT[(sp, tp)]
        m = FIG2_TP_MULT.get(tp, max(1.0, 8.0 / tp))
        if sp > 1:                   # ring overhead for decode SP
            m *= 1.0 + 0.12 * np.log2(sp)
        return m

    def latency(self, batch: int, cache_tokens: float, sp: int = 1,
                tp: int = 8) -> float:
        chips = sp * tp
        return self.mult(sp, tp) * (
            self.base + self.w_cache * cache_tokens / chips
            + self.w_batch * batch)

    def piggyback_latency(self, batch: int, cache_tokens: float,
                          sp: int = 1, tp: int = 8) -> float:
        """Virtual-time cost of one decode tick executed *inside* a
        co-resident prefill chunk's step window: only the marginal
        attention/batch terms, scaled by ``piggyback_factor`` — the
        ``base`` launch/weight-stream overhead is absorbed by the chunk.
        Strictly below ``latency`` for any batch, which is what makes
        piggybacked TBT dominate the stall-to-window-end baseline."""
        chips = sp * tp
        return self.mult(sp, tp) * self.piggyback_factor * (
            self.w_cache * cache_tokens / chips + self.w_batch * batch)
