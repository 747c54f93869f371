"""The port's ServingEngine on a 4-position mesh against the reference's
single-device engine on the CPU (dist_progs/paged_engine_prog.py).

The prefill pool stripes over ``sp_axis`` and the decode pool over
``kv_split_axis`` (``make_context(mesh, "serve_paged")``): first chunks
run ring attention, second chunks ``ring_paged_prefill`` over the striped
history, decode ticks the split-KV paged island.  Prompts of 64, 56 and
64 tokens (the third a twin of the first, so its admission shares the
striped decode pages) run as two chunks each with an SP change 1 -> 2,
and must give exactly the reference engine's tokens, the port's unsharded
engine's, and, after a preemption mid-decode, the same again.  So must
the elastic runs of dist_progs/restripe_engine_prog.py (a live 2 -> 4 ->
2 restripe under residents, a 4 -> 2 restripe mid-prefill, a
controller's step down under backlog) and the mixed steps of
dist_progs/mixed_step_prog.py (decode colocated on the prefill
instances, piggybacked ticks in chunk windows, with a restripe at a
chunk boundary and a swap victim resuming into them): greedy tokens do
not depend on the schedule, so the one reference run is every trace's
oracle.  The reference engine runs once for the module."""

import numpy as np
import pytest
import torch

from repro.core.latency_model import table1_model as j_table1
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
import repro.core.chunk_planner as j_cp
import repro.serving.simulator as j_sim
import repro_torch.core.chunk_planner as t_cp
import repro_torch.serving.simulator as t_sim
from repro_torch.configs.registry import get_config
from repro_torch.core.latency_model import table1_model as t_table1
from repro_torch.launch.mesh import make_context, make_mesh
from repro_torch.models.attention import attention_block
from repro_torch.models.params import params_from_numpy
from repro_torch.models.sharding import CPU_CTX
from repro_torch.models.transformer import _slice, forward
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from test_torch_engine import _two_chunk
from port_fixtures import one_torch_thread  # noqa: F401

OUT = 8


def _prompts(vocab):
    rng = np.random.default_rng(42)
    # 64 -> chunks of 32, 56 -> chunks of 28: both divide over 4 positions
    prompts = [rng.integers(0, vocab, L).astype(np.int32)
               for L in (64, 56, 64)]
    prompts[2] = prompts[0].copy()      # twin: prefix sharing over stripes
    return prompts


def _run(Eng, Req, sim, cp, table1, cfg, params, prompts, preempt_at=None,
         restripes=(), arrivals=(0.0, 0.001, 0.002), **kw):
    spec = sim.ClusterSpec(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4))
    kw = {"max_seq": 128, "block_size": 16, **kw}
    eng = Eng(cfg, params, spec,
              _two_chunk(sim, cp, parallel=True)(table1(), spec),
              max_batch=4, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Req(rid=i, arrival=arrivals[i], prompt_len=len(p),
                       output_len=OUT), p)
    for n, at in restripes:
        eng.request_restripe(n, at=at)
    if preempt_at is not None:
        eng.preempt(0, at=preempt_at)
    outs = eng.serve()
    return eng, outs


@pytest.fixture(scope="module")
def runs(reduced_params_cache):
    jcfg, jp = reduced_params_cache("yi-9b")
    cfg = get_config("yi-9b").reduced()
    params = params_from_numpy(jp, cfg, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    ctx = make_context(make_mesh((4,), ("data",), device="cpu"),
                       "serve_paged")

    def port(c, **kw):
        return _run(TEngine, TRequest, t_sim, t_cp, t_table1, cfg, params,
                    prompts, ctx=c, **kw)

    sharded, outs = port(ctx)
    tt = sharded.reqs[0].token_times
    preempted, outs_pre = port(ctx, preempt_at=0.5 * (tt[2] + tt[3]))
    return dict(
        cfg=cfg, params=params, prompts=prompts, ctx=ctx, port=port,
        sharded=sharded, outs=outs, preempted=preempted, outs_pre=outs_pre,
        flat=port(CPU_CTX)[1],
        ref=_run(JEngine, JRequest, j_sim, j_cp, j_table1, jcfg, jp,
                 prompts)[1])


def test_sharded_engine_tokens_match_reference_engine(runs):
    """Token for token the reference's single-device engine, the port's
    unsharded engine, and greedy decoding with whole forwards."""
    assert runs["outs"] == runs["ref"] == runs["flat"]
    cfg, params = runs["cfg"], runs["params"]
    for rid, p in enumerate(runs["prompts"]):
        toks = list(p)
        for _ in range(len(runs["outs"][rid]) - 1):
            pos = torch.arange(len(toks), dtype=torch.int32)[None]
            logits, _, _ = forward(params, cfg, CPU_CTX,
                                   torch.tensor([toks]), pos, "train")
            toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab_size])))
        assert runs["outs"][rid][:-1] == toks[len(p):], rid


def test_sharded_engine_layout_and_accounting(runs):
    """Both pools stripe 4 ways, the twin's admission shares blocks, every
    request ran a two-chunk plan (SP 1 -> 2), and the pools drain."""
    eng = runs["sharded"]
    d = eng.dstates[0]
    assert d.kv_shards == 4 and eng.pkv.kv_shards == 4
    assert isinstance(d.kv.pools["0"]["k"], list)
    assert d.blocks.stats["shared"] > 0, "twin admission must share blocks"
    for r in eng.reqs.values():
        assert [sp for _, sp in r.chunk_plan] == [1, 2], r.chunk_plan
    bm = d.blocks
    assert bm.n_free == bm.total_blocks and not bm.allocs
    assert eng.pblocks.n_free == eng.pblocks.total_blocks


def test_sharded_engine_preemption_mid_decode(runs):
    """A decode-phase preemption (recompute over the striped pools) leaves
    every request's tokens unchanged."""
    assert runs["preempted"].reqs[0].preemptions >= 1
    assert runs["outs_pre"] == runs["outs"]


def _layer0(runs):
    cfg, params = runs["cfg"], runs["params"]
    return cfg, _slice(params["blocks"]["0"], 0)


def test_unsharded_pool_under_split_axis_raises(runs):
    """paged_engine_prog.py's decode guard: an unsharded pool under an
    active kv_split_axis refuses, naming kv_shards and the axis."""
    cfg, p0 = _layer0(runs)
    x = torch.zeros((1, 1, cfg.d_model), dtype=getattr(torch, cfg.dtype))
    cache = {"k": None, "v": None,
             "block_table": torch.zeros((1, 2), dtype=torch.int32)}
    with pytest.raises(ValueError, match="kv_shards") as e:
        attention_block(x, p0, cfg, runs["ctx"],
                        torch.zeros((1, 1), dtype=torch.int32), "decode",
                        cache=cache,
                        cache_len=torch.zeros((1,), dtype=torch.int32))
    assert "kv_split_axis" in str(e.value)


def test_unsharded_history_under_sp_axis_raises(runs):
    """The prefill guard: an unsharded history pool under ring attention
    refuses, naming kv_shards and sp_axis."""
    cfg, p0 = _layer0(runs)
    x = torch.zeros((1, 4, cfg.d_model), dtype=getattr(torch, cfg.dtype))
    hist = {"k_pool": None, "v_pool": None,
            "block_table": torch.zeros((1, 2), dtype=torch.int32),
            "len": torch.zeros((1,), dtype=torch.int32)}
    with pytest.raises(ValueError, match="kv_shards") as e:
        attention_block(x, p0, cfg, runs["ctx"],
                        torch.arange(4, dtype=torch.int32)[None], "prefill",
                        history=hist)
    assert "sp_axis" in str(e.value)



# ------------------------------------------------------- elastic restripe
def _drain_free(eng):
    assert not eng.preempt_log, "a live restripe must not preempt anyone"
    assert eng.stall_ticks == 0, "a live restripe must not stall decode"


def test_live_restripe_2_4_2_matches_reference_engine(runs):
    """restripe_engine_prog.py's live resizes: narrowed to 2 active shards
    before any prefill, widened 2 -> 4 mid-decode and narrowed 4 -> 2
    later (times between tokens 2/3 and 4/5 of the unresized run), with
    residents live and no drain: each resize moves the pages whose shard
    changes, and the tokens are the reference engine's."""
    tt = runs["sharded"].reqs[0].token_times
    eng, outs = runs["port"](runs["ctx"], restripes=[
        (2, None), (4, 0.5 * (tt[2] + tt[3])), (2, 0.5 * (tt[4] + tt[5]))])
    assert outs == runs["ref"]
    log = eng.restripe_log
    assert [e["n_new"] for e in log] == [2, 4, 2], log
    assert log[0]["migrated_blocks"] == 0, "no pages before any prefill"
    assert log[1]["migrated_blocks"] > 0 and log[2]["migrated_blocks"] > 0
    _drain_free(eng)
    d = eng.dstates[0]
    assert d.blocks.active_shards == 2 and eng.pblocks.active_shards == 2
    assert d.blocks.n_free == d.blocks.total_blocks and not d.blocks.allocs


def test_mid_prefill_restripe_matches_reference_engine(runs):
    """A 4 -> 2 restripe at request 0's second chunk's scheduled start:
    every request's first-chunk pages are live in the striped prefill
    pool.  At pages of 8 a 32-token first chunk spans stripe positions
    0-3, so positions 2 and 3 of each holder must move; the tokens are
    the reference engine's (pages of 16)."""
    s1 = runs["sharded"].reqs[0].chunk_sched[1][0]
    eng, outs = runs["port"](runs["ctx"], restripes=[(2, s1)], block_size=8)
    assert outs == runs["ref"]
    log = eng.restripe_log
    assert log and log[0]["n_new"] == 2 and log[0]["migrated_blocks"] > 0, \
        log
    _drain_free(eng)


def test_controller_restripe_matches_reference_engine(runs):
    """A DynamicRateController preloaded with a sustained queue backlog
    (restripe_engine_prog.py:141-150) steps the stripe width down from 4
    to 2 at the first chunk boundary, unasked; tokens unchanged."""
    from repro_torch.core.improvement_rate import DynamicRateController
    ctl = DynamicRateController(table={}, window=30.0)
    for k in range(20):
        ctl.observe_queue(-1e-3 * k, 5.0)       # pressure above 1.5 s
    eng, outs = runs["port"](runs["ctx"], rate_controller=ctl)
    assert outs == runs["ref"]
    log = eng.restripe_log
    assert log and (log[0]["n_old"], log[0]["n_new"]) == (4, 2), log


# ------------------------------------------------------------ mixed steps
MIXED = dict(max_seq=96, prefill_pool_blocks=64, piggyback=True,
             preempt_policy="swap", arrivals=(0.0, 0.3, 0.45),
             decode_hosts={0: tuple(range(8))})


@pytest.fixture(scope="module")
def mixed(runs):
    """mixed_step_prog.py's colocated run on the mesh: the decode
    instance hosted on all 8 prefill instances, so chunk steps carry
    piggybacked ticks."""
    return runs["port"](runs["ctx"], **MIXED)


def _conserved(eng):
    ms = eng.mixed_stats
    total = sum(r.output_len for r in eng.reqs.values())
    assert ms["piggyback_tokens"] + ms["standalone_tokens"] == total, \
        (ms, total)
    return ms


@pytest.mark.parametrize("trace", ["piggyback", "restripe", "swap"])
def test_mixed_steps_on_mesh_match_reference_engine(runs, mixed, trace):
    """Mixed prefill/decode steps on the 4-position mesh: the colocated
    run (an SP 1 -> 2 plan among its requests), the same with a 4 -> 2
    restripe at request 1's second chunk's start, and with request 0
    swap-preempted between its 6th and 7th token, its KV through the
    host tier, resuming while fused windows still run.  Every trace gives
    the reference engine's tokens and conserves ticks (piggybacked plus
    standalone tokens are the output lengths)."""
    eng, outs = mixed
    if trace == "restripe":
        s1 = eng.reqs[1].chunk_sched[1][0]
        eng, outs = runs["port"](runs["ctx"], restripes=[(2, s1)], **MIXED)
        assert eng.restripe_log and eng.restripe_log[0]["n_new"] == 2
    elif trace == "swap":
        tt = eng.reqs[0].token_times
        t_pre = 0.5 * (tt[5] + tt[6])
        eng, outs = runs["port"](runs["ctx"], preempt_at=t_pre, **MIXED)
        pre = [p for p in eng.preempt_log if p["rid"] == 0]
        assert len(pre) == 1 and pre[0]["policy"] == "swap", eng.preempt_log
        assert eng.swap_stats["swap_outs"] >= 1
        assert eng.swap_stats["swap_ins"] >= 1
        assert any(m["t"] > t_pre for m in eng.mixed_log), eng.mixed_log
    else:
        assert any(len(r.chunk_sched) == 2 for r in eng.reqs.values())
    ms = _conserved(eng)
    assert ms["fused_steps"] > 0 and ms["piggyback_ticks"] > 0, ms
    assert outs == runs["ref"]
