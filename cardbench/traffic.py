"""The one traffic generator: a traffic file's parameters -> requests.

A traffic file (``cardbench/traffic/<name>.json``) gives the prompt and
output length distributions, the open loop's fixed rate and the serving
engine's settings.  Lengths are truncated lognormals whose mean is the
file's ``mean`` (the paper's trace model, copied from
``repro_torch.serving.workload`` and cut to one card's lengths); gaps
are exponential (Poisson arrivals).

Every seed gets the same work: prompt lengths, output lengths and gaps
are each the stratified sample ``q((i + 0.5) / n)`` of their
distribution's quantile function, in an order that is a permutation
drawn from the file's ``order_seed`` (so arrivals keep a Poisson
process's bursts), and the seed draws only the prompt tokens (and, in
``run.py``, the weights).  Seeds that permuted the schedule moved the
tails by 20-50% from seed to seed (PERF.md), which is the draw's spread
and not the system's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List, Optional

import numpy as np

_NORMAL = NormalDist()


@dataclass
class Job:
    """One request of a run: its index, its due time (seconds after the
    window opens), its prompt tokens and its output length."""
    idx: int
    due: float
    prompt: np.ndarray
    output_len: int

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _normal_q(p: np.ndarray) -> np.ndarray:
    return np.array([_NORMAL.inv_cdf(float(x)) for x in p])


def clipped_lognormal_mu(lo: float, hi: float, mean: float,
                         sigma: float) -> float:
    """The ``mu`` of a lognormal of shape ``sigma`` whose values, clipped
    to [lo, hi], have mean ``mean`` (the port's trace model clips, as
    ``workload.sample_lengths`` does).  Bisection on a fine quantile
    grid: the clipped mean rises with mu."""
    if not lo < mean < hi:
        raise ValueError(f"mean {mean} outside ({lo}, {hi})")
    z = _normal_q(_quantiles(4096))
    a, b = math.log(lo) - 4 * sigma, math.log(hi) + 4 * sigma
    for _ in range(80):
        mu = 0.5 * (a + b)
        m = np.exp(np.clip(mu + sigma * z, math.log(lo), math.log(hi))).mean()
        a, b = (mu, b) if m < mean else (a, mu)
    return 0.5 * (a + b)


def lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` stratified lengths of ``spec`` {"min", "max", "mean",
    "sigma"}, ascending."""
    lo, hi = float(spec["min"]), float(spec["max"])
    mu = clipped_lognormal_mu(lo, hi, float(spec["mean"]),
                              float(spec["sigma"]))
    x = np.exp(np.clip(mu + float(spec["sigma"]) * _normal_q(_quantiles(n)),
                       math.log(lo), math.log(hi)))
    return np.round(x).astype(np.int64)


def n_requests(traffic: dict, seconds: float) -> int:
    """Requests in a run: the rate times the window."""
    return max(1, int(round(float(traffic["rate_per_s"]) * seconds)))


def make_jobs(traffic: dict, seed: int, seconds: float, vocab: int,
              rate: Optional[float] = None) -> List[Job]:
    """The run's requests: the same lengths and gaps for every seed, in
    the file's order, prompts drawn from the seed uniformly from
    ``vocab``.  ``rate`` overrides the file's (the knee sweep)."""
    t = dict(traffic)
    if rate is not None:
        t["rate_per_s"] = rate
    n = n_requests(t, seconds)
    rng = np.random.default_rng(seed)
    order = np.random.default_rng(int(t.get("order_seed", 0)))
    plens = order.permutation(lengths(t["prompt"], n))
    olens = order.permutation(lengths(t["output"], n))
    r = float(t["rate_per_s"])
    gaps = order.permutation(-np.log1p(-_quantiles(n)) / r)
    # the gaps are the Poisson process's n inter-arrival times; the first
    # request is due one gap after the window opens and the last one a gap
    # before it closes, at the file's rate on average
    due = np.cumsum(gaps) * (seconds / (gaps.sum() + 1.0 / r))
    return [Job(i, float(due[i]),
                rng.integers(0, vocab, int(plens[i]), dtype=np.int64)
                .astype(np.int32), int(olens[i]))
            for i in range(n)]
