"""The port's ServingEngine against the reference engine on the CPU.

Each scenario of the reference's engine tests runs through both engines
with the same trace and the same (bridged) weights.  The engine clock is
modelled, so the records must match exactly: generated tokens,
``chunk_log``, ``preempt_log``, ``mixed_stats`` and ``swap_stats``."""

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


def _mixed_two_chunk(sim, cp):
    """tests/test_mixed_steps.py's ParallelTwoChunkPolicy: the per-rid
    instance pair of ``_two_chunk(parallel=True)``, its chunks timed from
    0 rather than from the pool's queue."""

    class MixedTwoChunk(sim.Policy):
        name = "two_chunk_par"

        def plan(self, req, pool, now):
            L = req.prompt_len
            base = (2 * req.rid) % (self.spec.n_prefill - 1)
            if L >= 32:
                l0 = L // 2
                t0 = self.model.latency(1, 0, l0)
                t1 = self.model.latency(2, l0, L - l0)
                return cp.Allocation([
                    cp.Chunk(l0, (base,), 0.0, t0),
                    cp.Chunk(L - l0, (base, base + 1), t0, t0 + t1)])
            t = self.model.latency(1, 0, L)
            return cp.Allocation([cp.Chunk(L, (base,), 0.0, t)])

    return MixedTwoChunk


def _run(side, params, cfg, spec_kw, policy, reqs, engine_kw, preempt=()):
    Eng, Req, sim, cp, table1, extra = SIDES[side]
    spec = sim.ClusterSpec(**spec_kw)
    model = table1()
    if policy in ("two_chunk", "parallel"):
        pol = _two_chunk(sim, cp, parallel=policy == "parallel")(model, spec)
    elif policy == "parallel_mixed":
        pol = _mixed_two_chunk(sim, cp)(model, spec)
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


def _trace(cfg, seed, n, lo, hi, gap, out_len, fixed=None, arrivals=None,
           prefix=0):
    """``n`` requests, every ``gap`` seconds (or at ``arrivals``), with
    ``out_len`` output tokens (an int, or one per request).  ``prefix``
    draws a common prompt prefix of that many tokens first, each prompt
    then continuing with tokens of its own."""
    rng = np.random.default_rng(seed)
    common = (rng.integers(0, cfg.vocab_size, prefix) if prefix
              else np.zeros(0, np.int64))
    outs = out_len if isinstance(out_len, tuple) else (out_len,) * n
    reqs = []
    for i in range(n):
        plen = fixed or int(rng.integers(lo, hi))
        prompt = np.concatenate([common, rng.integers(0, cfg.vocab_size,
                                                      plen)])
        reqs.append((i, i * gap if arrivals is None else arrivals[i],
                     prompt.astype(np.int32), outs[i]))
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
    # tests/test_engine.py:18 (mamba2-1.3b) — an attention-free model: no
    # KV pages, each request's SSD state and conv window ride the aux
    # history from chunk to chunk and into the decode batch
    "mamba_tetris": dict(
        arch="mamba2-1.3b",
        spec=dict(n_prefill=16, n_decode=2, sp_candidates=(1, 2, 4, 8)),
        policy="tetris", engine=dict(max_batch=4, max_seq=256),
        trace=dict(seed=1, n=4, lo=20, hi=90, gap=0.05, out_len=3)),
    # tests/test_paged_engine.py:46 (mamba2-1.3b) — two chunks per prompt:
    # the second chunk starts from the first's SSD state and conv window
    "mamba_multichunk": dict(
        arch="mamba2-1.3b",
        spec=dict(n_prefill=8, n_decode=2, sp_candidates=(1, 2, 4)),
        policy="two_chunk",
        engine=dict(max_batch=4, max_seq=256, block_size=32),
        trace=dict(seed=7, n=2, lo=40, hi=90, gap=0.03, out_len=3)),
    # reduced Qwen1.5-MoE (q/k/v bias, MHA, an MoE FFN with a shared
    # expert): tetris plans, and two chunks per prompt over paged history;
    # each decode tick routes its four rows (idle ones included) as one
    # group, as the reference does
    "moe_tetris": dict(
        arch="qwen2-moe-a2.7b",
        spec=dict(n_prefill=16, n_decode=2, sp_candidates=(1, 2, 4, 8)),
        policy="tetris", engine=dict(max_batch=4, max_seq=256),
        trace=dict(seed=1, n=3, lo=20, hi=90, gap=0.05, out_len=3)),
    "moe_multichunk": dict(
        arch="qwen2-moe-a2.7b",
        spec=dict(n_prefill=8, n_decode=2, sp_candidates=(1, 2, 4)),
        policy="two_chunk",
        engine=dict(max_batch=4, max_seq=256, block_size=32),
        trace=dict(seed=7, n=2, lo=40, hi=90, gap=0.03, out_len=3)),
    # reduced Qwen2-VL-72B: M-RoPE, so every chunk and decode tick hands
    # the model (3, B, S) positions built by the engine; two chunks per
    # prompt over paged history
    "mrope_multichunk": dict(
        arch="qwen2-vl-72b",
        spec=dict(n_prefill=8, n_decode=2, sp_candidates=(1, 2, 4)),
        policy="two_chunk",
        engine=dict(max_batch=4, max_seq=256, block_size=32),
        trace=dict(seed=7, n=2, lo=40, hi=90, gap=0.03, out_len=3)),
    # reduced Mixtral-8x22B: an MoE under a sliding window of 8, with
    # prompts of 40-90 tokens in two chunks, so the history chunk and the
    # decode ticks mask by window
    "swa_moe_multichunk": dict(
        arch="mixtral-8x22b",
        spec=dict(n_prefill=8, n_decode=2, sp_candidates=(1, 2, 4)),
        policy="two_chunk",
        engine=dict(max_batch=4, max_seq=256, block_size=32),
        trace=dict(seed=7, n=2, lo=40, hi=90, gap=0.03, out_len=3)),
    # tests/test_kv_offload.py:23 — the same pressure with
    # preempt_policy="swap": victims park their pages on the host tier and
    # swap back in
    "swap_pressure": dict(
        spec=dict(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4)),
        policy="parallel",
        engine=dict(max_batch=4, max_seq=48, block_size=16,
                    preempt_policy="swap"),
        trace=dict(seed=21, n=3, lo=0, hi=0, gap=0.005, out_len=6,
                   fixed=60)),
    # tests/test_prefix_sharing.py:56 — two prompts with a common 48-token
    # prefix: the second's admission shares the first's full blocks
    "shared_prefix": dict(
        spec=dict(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4)),
        policy="parallel",
        engine=dict(max_batch=4, max_seq=256, block_size=16,
                    prefix_sharing=True),
        trace=dict(seed=31, n=2, lo=0, hi=0, gap=0.01, out_len=(12, 6),
                   fixed=16, prefix=48)),
    # tests/test_mixed_steps.py:66 — decode colocated with the prefill
    # instances: ticks ride chunk steps (piggyback), or wait for the
    # chunk window to end (stall)
    "piggyback": dict(
        spec=dict(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4)),
        policy="parallel_mixed",
        engine=dict(max_batch=4, max_seq=80, block_size=16,
                    decode_hosts={0: tuple(range(8))}, piggyback=True,
                    prefill_pool_blocks=64),
        trace=dict(seed=1, n=4, lo=0, hi=0, gap=0.0, out_len=6, fixed=60,
                   arrivals=(0.0, 0.0, 0.35, 0.45))),
    "piggyback_stall": dict(
        spec=dict(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4)),
        policy="parallel_mixed",
        engine=dict(max_batch=4, max_seq=80, block_size=16,
                    decode_hosts={0: tuple(range(8))}, piggyback=False,
                    prefill_pool_blocks=64),
        trace=dict(seed=1, n=4, lo=0, hi=0, gap=0.0, out_len=6, fixed=60,
                   arrivals=(0.0, 0.0, 0.35, 0.45))),
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
    arch = sc.get("arch", "yi-9b")
    jcfg, jp = reduced_params_cache(arch)
    cfg = get_config(arch).reduced()
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
    assert port.swap_stats == ref.swap_stats
    assert all(len(v) > 0 for v in port.outputs.values())
    if scenario == "swap_pressure":
        assert port.swap_stats["swap_outs"] >= 1
        assert all(e["policy"] == "swap" for e in port.preempt_log)
    if scenario == "shared_prefix":
        assert port.dstates[0].blocks.stats["shared"] >= 3
    if scenario == "piggyback":
        assert port.mixed_stats["piggyback_ticks"] > 0
        assert port.mixed_stats["fused_steps"] > 0
    if scenario == "piggyback_stall":
        assert port.mixed_stats["piggyback_ticks"] == 0
        assert port.mixed_stats["deferred_ticks"] > 0
    if scenario == "block_exhaustion":
        assert port.preempt_log, "the tight pool must preempt"
    if scenario == "preempt_requeue":
        assert port.reqs[0].preemptions == 1
    if scenario.endswith("multichunk"):
        assert all(len(r.chunk_plan) == 2 for r in port.reqs.values())
    if scenario == "swa_moe_multichunk":
        assert cfg.sliding_window == 8
        assert all(r.prompt_len > 2 * 8 for r in port.reqs.values())


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-1.3b", "qwen2-moe-a2.7b",
                                  "chatglm3-6b", "qwen2-vl-72b"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    """The port's launcher end to end on the plain path, for the reduced
    dense default (yi-9b), the attention-free Mamba-2, the MoE, ChatGLM3
    (partial rotary, q/k/v bias) and Qwen2-VL (M-RoPE): every request gets
    a chunk plan and tokens, and the latency summary prints."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                "--output-len", "3"])
    out = capsys.readouterr().out
    assert out.count("plan=[(") == 3 and "TTFT p50" in out
