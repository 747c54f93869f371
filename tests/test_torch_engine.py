"""The port's ServingEngine against the reference engine on the CPU.

Each scenario of the reference's engine tests runs through both engines
with the same trace and the same (bridged) weights.  The engine clock is
modelled, so the records must match exactly: generated tokens,
``chunk_log``, ``preempt_log`` and ``mixed_stats``."""

import numpy as np
import pytest

import repro.core.chunk_planner as j_cp
import repro.serving.simulator as j_sim
import repro_torch.core.chunk_planner as t_cp
import repro_torch.serving.simulator as t_sim
from repro.core.latency_model import table1_model as j_table1
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core.latency_model import table1_model as t_table1
from repro_torch.models.params import params_from_numpy
from repro_torch.models.sharding import CPU_CTX
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest

# one side per package: (engine, request, simulator module, planner module,
# latency model, extra engine kwargs)
SIDES = {"ref": (JEngine, JRequest, j_sim, j_cp, j_table1, {}),
         "port": (TEngine, TRequest, t_sim, t_cp, t_table1,
                  {"ctx": CPU_CTX})}


def _two_chunk(sim, cp, parallel=False):
    """tests/test_paged_engine.py's TwoChunkPolicy (and its per-rid
    parallel variant) over one package's Policy/Allocation/Chunk."""

    class TwoChunk(sim.Policy):
        name = "two_chunk"

        def plan(self, req, pool, now):
            L = req.prompt_len
            base = (2 * req.rid) % (self.spec.n_prefill - 1) if parallel \
                else 0
            hi = base + 1
            if L >= 32:
                l0 = L // 2
                t_q = pool[base]
                t0 = t_q + self.model.latency(1, 0, l0)
                t1 = max(t0, pool[hi]) + self.model.latency(2, l0, L - l0)
                return cp.Allocation([cp.Chunk(l0, (base,), t_q, t0),
                                      cp.Chunk(L - l0, (base, hi), t0, t1)])
            lone = base if parallel else 2
            t_q = pool[lone]
            t_p = self.model.latency(1, 0, L)
            return cp.Allocation([cp.Chunk(L, (lone,), t_q, t_q + t_p)])

    return TwoChunk


def _run(side, params, cfg, spec_kw, policy, reqs, engine_kw, preempt=()):
    Eng, Req, sim, cp, table1, extra = SIDES[side]
    spec = sim.ClusterSpec(**spec_kw)
    model = table1()
    if policy in ("two_chunk", "parallel"):
        pol = _two_chunk(sim, cp, parallel=policy == "parallel")(model, spec)
    else:
        pol = sim.make_policy(policy, model, spec)
    eng = Eng(cfg, params, spec, pol, **engine_kw, **extra)
    for rid, arrival, prompt, out_len in reqs:
        eng.submit(Req(rid=rid, arrival=arrival, prompt_len=len(prompt),
                       output_len=out_len), prompt)
    for rid, at in preempt:
        eng.preempt(rid, at=at)
    eng.serve()
    return eng


def _trace(cfg, seed, n, lo, hi, gap, out_len, fixed=None):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = fixed or int(rng.integers(lo, hi))
        reqs.append((i, i * gap,
                     rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                     out_len))
    return reqs


# The reference tests' traces, cut to keep this file short (the reference
# engine's compiles and decode ticks are most of its time): 3 output
# tokens, 6 for block_exhaustion (enough for decode growth to exhaust its
# pool), and two requests for multichunk_paged.
SCENARIOS = {
    # tests/test_engine.py:20 — tetris plans, two decode instances
    "engine_tetris": dict(
        spec=dict(n_prefill=16, n_decode=2, sp_candidates=(1, 2, 4, 8)),
        policy="tetris", engine=dict(max_batch=4, max_seq=256),
        trace=dict(seed=1, n=4, lo=20, hi=90, gap=0.05, out_len=3)),
    # tests/test_paged_engine.py:47 — two chunks per prompt, SP 1 -> 2
    "multichunk_paged": dict(
        spec=dict(n_prefill=8, n_decode=2, sp_candidates=(1, 2, 4)),
        policy="two_chunk",
        engine=dict(max_batch=4, max_seq=256, block_size=32),
        trace=dict(seed=7, n=2, lo=40, hi=90, gap=0.03, out_len=3)),
    # tests/test_paged_engine.py:97 — preempted between chunks, requeued
    "preempt_requeue": dict(
        spec=dict(n_prefill=8, n_decode=2, sp_candidates=(1, 2, 4)),
        policy="two_chunk",
        engine=dict(max_batch=4, max_seq=256, block_size=32),
        trace=dict(seed=11, n=1, lo=0, hi=0, gap=0.0, out_len=3, fixed=64),
        preempt=((0, 1e-6),)),
    # tests/test_paged_engine.py:200 — decode growth exhausts a tight pool
    "block_exhaustion": dict(
        spec=dict(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4)),
        policy="parallel",
        engine=dict(max_batch=4, max_seq=48, block_size=16),
        trace=dict(seed=21, n=3, lo=0, hi=0, gap=0.005, out_len=6,
                   fixed=60)),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_records_match_reference(scenario, reduced_params_cache):
    sc = SCENARIOS[scenario]
    jcfg, jp = reduced_params_cache("yi-9b")
    cfg = get_config("yi-9b").reduced()
    tp = params_from_numpy(jp, cfg, device="cpu")
    reqs = _trace(cfg, **sc["trace"])
    runs = {side: _run(side, p, c, sc["spec"], sc["policy"], reqs,
                       sc["engine"], sc.get("preempt", ()))
            for side, p, c in (("ref", jp, jcfg), ("port", tp, cfg))}
    ref, port = runs["ref"], runs["port"]
    assert port.outputs == ref.outputs
    assert port.chunk_log == ref.chunk_log
    assert port.preempt_log == ref.preempt_log
    assert port.mixed_stats == ref.mixed_stats
    assert all(len(v) > 0 for v in port.outputs.values())
    if scenario == "block_exhaustion":
        assert port.preempt_log, "the tight pool must preempt"
    if scenario == "preempt_requeue":
        assert port.reqs[0].preemptions == 1


def test_serve_cli_runs_on_cpu(capsys):
    """The port's launcher end to end on the plain path: every request
    gets a chunk plan and tokens, and the latency summary prints."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "3", "--output-len", "3"])
    out = capsys.readouterr().out
    assert out.count("plan=[(") == 3 and "TTFT p50" in out
