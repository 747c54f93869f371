"""The port's ServingEngine on a 4-position mesh against the reference's
single-device engine on the CPU (dist_progs/paged_engine_prog.py).

The prefill pool stripes over ``sp_axis`` and the decode pool over
``kv_split_axis`` (``make_context(mesh, "serve_paged")``): first chunks
run ring attention, second chunks ``ring_paged_prefill`` over the striped
history, decode ticks the split-KV paged island.  Prompts of 64, 56 and
64 tokens (the third a twin of the first, so its admission shares the
striped decode pages) run as two chunks each with an SP change 1 -> 2,
and must give exactly the reference engine's tokens, the port's unsharded
engine's, and, after a preemption mid-decode, the same again.  The
reference engine runs once for the module."""

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

OUT = 8


def _prompts(vocab):
    rng = np.random.default_rng(42)
    # 64 -> chunks of 32, 56 -> chunks of 28: both divide over 4 positions
    prompts = [rng.integers(0, vocab, L).astype(np.int32)
               for L in (64, 56, 64)]
    prompts[2] = prompts[0].copy()      # twin: prefix sharing over stripes
    return prompts


def _run(Eng, Req, sim, cp, table1, cfg, params, prompts, preempt_at=None,
         **kw):
    spec = sim.ClusterSpec(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4))
    eng = Eng(cfg, params, spec,
              _two_chunk(sim, cp, parallel=True)(table1(), spec),
              max_batch=4, max_seq=128, block_size=16, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Req(rid=i, arrival=i * 0.001, prompt_len=len(p),
                       output_len=OUT), p)
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
        cfg=cfg, params=params, prompts=prompts, ctx=ctx,
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

