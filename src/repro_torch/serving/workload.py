"""Workload generation matching the paper's production traces.

Three length distributions (Sec. 7.1): Short (4k-95k, mean 23.6k), Medium
(8k-142k, mean 32.8k), Long (16k-190k, mean 50.1k) — modelled as truncated
lognormals whose sigma is solved so the truncated mean matches the reported
average.  Arrivals are Poisson (the paper's simulator does the same).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclass(frozen=True)
class TraceSpec:
    name: str
    min_len: int
    max_len: int
    mean_len: float


TRACES = {
    "short":  TraceSpec("short",  4_096, 97_280, 24_166),   # 4k-95k, ~23.6k
    "medium": TraceSpec("medium", 8_192, 145_408, 33_587),  # 8k-142k, ~32.8k
    "long":   TraceSpec("long",   16_384, 194_560, 51_302), # 16k-190k, ~50.1k
}


def _solve_sigma(spec: TraceSpec, rng: np.random.Generator,
                 n_probe: int = 20000) -> tuple[float, float]:
    """Find (mu, sigma) of a lognormal so that, truncated to
    [min_len, max_len], the mean matches spec.mean_len."""
    lo, hi = np.log(spec.min_len), np.log(spec.max_len)
    target = spec.mean_len
    best = (0.0, 1.0, float("inf"))
    probe = rng.standard_normal(n_probe)
    for sigma in np.linspace(0.3, 1.6, 27):
        for mu_f in np.linspace(0.05, 0.9, 18):
            mu = lo + mu_f * (hi - lo)
            x = np.exp(np.clip(mu + sigma * probe, lo, hi))
            err = abs(x.mean() - target)
            if err < best[2]:
                best = (mu, sigma, err)
    return best[0], best[1]


_SIGMA_CACHE: dict = {}


def sample_lengths(trace: str, n: int, seed: int = 0) -> np.ndarray:
    spec = TRACES[trace]
    rng = np.random.default_rng(seed)
    if trace not in _SIGMA_CACHE:
        _SIGMA_CACHE[trace] = _solve_sigma(spec, np.random.default_rng(123))
    mu, sigma = _SIGMA_CACHE[trace]
    x = np.exp(np.clip(mu + sigma * rng.standard_normal(n),
                       np.log(spec.min_len), np.log(spec.max_len)))
    return np.round(x).astype(np.int64)


def make_trace(trace: str, rate: float, duration: float, seed: int = 0,
               output_mean: int = 250) -> List[Request]:
    """Poisson arrivals at ``rate`` req/s over ``duration`` seconds."""
    rng = np.random.default_rng(seed + 7)
    arrivals = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t > duration:
            break
        arrivals.append(t)
    n = len(arrivals)
    lens = sample_lengths(trace, n, seed)
    outs = np.maximum(16, rng.lognormal(np.log(output_mean), 0.6, n)
                      ).astype(np.int64)
    return [Request(rid=i, arrival=a, prompt_len=int(l), output_len=int(o))
            for i, (a, l, o) in enumerate(zip(arrivals, lens, outs))]
