"""Elastic SP and TP x SP in the port against the reference on the CPU.

The reference proves its live restripe and its head-sharded pools in
multi-device programs (dist_progs/restripe_engine_prog.py,
gqa_head_shard_prog.py), which tier-1 skips.  Here the port's pieces,
driven by one process over CPU meshes (launch/mesh.py), are held to the
reference: ``BlockManager.restripe``'s (old, new) pairs on the same
allocation history, ``PagedKVCache.restripe`` and the head-sharded page
ops against the pages' logical content, and the ServingEngine on a
2 x 2 ("data" x "model") mesh with the reduced llama3_8b (KVH 4: pools
head-sharded 2 ways) against the reference's single-device engine.  The
reference engine runs once for the module."""

import numpy as np
import pytest
import torch

import repro.core.chunk_planner as j_cp
import repro.serving.simulator as j_sim
import repro_torch.core.chunk_planner as t_cp
import repro_torch.serving.simulator as t_sim
from repro.core.latency_model import table1_model as j_table1
from repro.serving.cache_manager import BlockManager as JBlockManager
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs.registry import get_config
from repro_torch.core.latency_model import table1_model as t_table1
from repro_torch.kernels.flash_decode import shard_restripe_kv_blocks
from repro_torch.kernels.ref import sharded_pool_view
from repro_torch.launch.mesh import make_context, make_mesh
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.cache_manager import BlockManager, PagedKVCache
from repro_torch.serving.cache_manager import shard_block_table
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from test_torch_engine import _two_chunk
from port_fixtures import one_torch_thread  # noqa: F401

OUT = 8


def _history(bm, rng):
    """The same allocation history on any BlockManager: requests opened,
    grown page by page and released, one prefix-shared."""
    for rid in range(5):
        bm.open(rid)
        bm.extend(rid, int(rng.integers(9, 60)))
    bm.release(1)
    # a prefix-shared admission: two of request 0's pages plus 13 tokens
    bm.reserve_virtual(7, 13, offset=2)
    bm.commit(7, shared=bm.allocs[0][:2])
    bm.extend(7, 2 * bm.block_size + 21)
    bm.extend(3, 70)


@pytest.mark.parametrize("steps", [(2, 4, 3, 2), (3, 4, 2)])
def test_block_manager_restripe_matches_reference(steps):
    """Port and reference BlockManagers on the same history give the same
    (old, new) pairs at every resize, the same allocations after it, and
    every page at stripe position i on shard ``i % n``; both refuse a
    stripe of one shard, which cannot hold the live pages."""
    seed = sum(steps)
    books = [M(total_blocks=96, block_size=8, kv_shards=4)
             for M in (BlockManager, JBlockManager)]
    for bm in books:
        _history(bm, np.random.default_rng(seed))
    port, ref = books
    assert port.allocs == ref.allocs
    assert not port.can_restripe(1) and not ref.can_restripe(1)
    for n in steps:
        assert port.can_restripe(n) == ref.can_restripe(n)
        pairs = port.restripe(n)
        assert pairs == ref.restripe(n)
        assert port.allocs == ref.allocs and port.ref == ref.ref
        for blocks in port.allocs.values():
            assert all(port.shard_of(b) == i % n
                       for i, b in enumerate(blocks))
        assert all(port.shard_of(o) != port.shard_of(w) for o, w in pairs)


def _pool_case(head_sharded: bool):
    """A PagedKVCache striped 4 ways (on a 4 x 2 mesh, its KV heads
    sharded 2 ways when ``head_sharded``) with three requests' pages
    written, their BlockManager, and the dense KV each page holds."""
    cfg = get_config("llama3-8b").reduced()
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    page, total = 8, 48
    kv = PagedKVCache(cfg, total, page, kv_shards=4, mesh=mesh,
                      shard_axis="data",
                      head_axis="model" if head_sharded else None)
    bm = BlockManager(total_blocks=total, block_size=page, kv_shards=4,
                      kv_head_shards=kv.kv_head_shards)
    rng = np.random.default_rng(4)
    dense = {}
    for rid, L in enumerate((45, 30, 61)):
        bm.open(rid)
        bm.extend(rid, L)
        ent = {p: torch.from_numpy(rng.standard_normal(
            (cfg.n_blocks, 1, L, cfg.n_kv_heads, cfg.head_dim_)).astype(
                np.float32)) for p in ("k", "v")}
        kv.write_chunk(bm.allocs[rid], {"0": {"self": ent}},
                       torch.arange(L, dtype=torch.int32)[None])
        dense[rid] = ent
    return cfg, kv, bm, dense


def _views(kv, bm):
    """Every request's logical-order view (sharded_pool_view over the
    live stripe's rows of its per-shard tables), per part, layer block
    0."""
    out = {}
    n = bm.active_shards
    for rid, blocks in bm.allocs.items():
        bt = torch.as_tensor(shard_block_table(
            np.asarray(blocks, np.int32)[None], n, bm.blocks_per_shard,
            n_slots=bm.kv_shards))[:n]
        out[rid] = {p: sharded_pool_view(
            [[x[0] for x in s] if isinstance(s, list) else s[0]
             for s in kv.pools["0"][p][:n]],
            bt)[0, :len(blocks) * bm.block_size] for p in ("k", "v")}
    return out


@pytest.mark.parametrize("head_sharded", [False, True],
                         ids=["striped", "head_sharded"])
def test_paged_kv_cache_restripe_keeps_logical_view(head_sharded):
    """PagedKVCache.restripe moves the pages of a live 4 -> 2 -> 3 -> 4
    resize: each request's logical-order view stays bit-identical (and
    equal to the KV written), and stripe position i sits on shard i % n.
    Per position the pool holds exactly 1 / (sp * tp) of the reference's
    stacked (nb, 4, bps + 1, page, KVH, D) pool when head-sharded (tp =
    2 on the 4 x 2 mesh), 1 / sp when not."""
    cfg, kv, bm, dense = _pool_case(head_sharded)
    shard0 = kv.pools["0"]["k"][0]
    full = (cfg.n_blocks * 4 * (48 // 4 + 1) * 8 * cfg.n_kv_heads
            * cfg.head_dim_ * 4)
    if head_sharded:
        assert kv.kv_head_shards == 2 and len(shard0) == 2
        assert shard0[0].nbytes * 4 * 2 == full
    else:
        assert kv.kv_head_shards == 1 and shard0.nbytes * 4 == full
    before = _views(kv, bm)
    for rid, v in before.items():
        L = dense[rid]["k"].shape[2]
        for p in ("k", "v"):
            assert torch.equal(v[p][:L], dense[rid][p][0, 0])
    moved = 0
    for n in (2, 3, 4):
        pairs = bm.restripe(n)
        kv.restripe(pairs)
        moved += len(pairs)
        after = _views(kv, bm)
        for rid in before:
            for p in ("k", "v"):
                assert torch.equal(after[rid][p], before[rid][p]), (n, rid)
            assert all(bm.shard_of(b) == i % n
                       for i, b in enumerate(bm.allocs[rid]))
    assert moved > 0


def test_shard_restripe_kv_blocks_moves_only_named_pages():
    """One exchange over 3 shards: each named page lands in its slot on
    the destination (payloads padded with the scratch page to the
    largest pairwise count), and every other page, scratch aside, is
    untouched."""
    rng = np.random.default_rng(2)
    pools = [torch.from_numpy(rng.standard_normal((2, 7, 4, 2, 8)).astype(
        np.float32)) for _ in range(3)]
    before = [p.clone() for p in pools]
    bps = 6
    send = np.full((3, 3, 2), bps, np.int32)
    recv = np.full((3, 3, 2), bps, np.int32)
    moves = [(0, 1, 2, 5), (0, 1, 3, 0), (2, 0, 1, 4), (1, 2, 0, 3)]
    for s, d, lo, ln in moves:
        t = int((send[s, d] != bps).sum())
        send[s, d, t], recv[d, s, t] = lo, ln
    shard_restripe_kv_blocks(pools, send, recv)
    written = {(d, ln) for _, d, _, ln in moves}
    for s, d, lo, ln in moves:
        assert torch.equal(pools[d][:, ln], before[s][:, lo])
    for d in range(3):
        for j in range(bps):
            if (d, j) not in written:
                assert torch.equal(pools[d][:, j], before[d][:, j])


def test_head_sharded_pool_page_ops_keep_logical_content():
    """The head-sharded pool (4 shards x 2 head slices) against an
    unsharded one fed the same operations: a chunk scatter, a
    copy-on-write copy within a shard, a host swap-in, copies into and
    out of it; every page's logical content (read_blocks, full width)
    stays equal."""
    cfg, kv, bm, _ = _pool_case(True)
    flat = PagedKVCache(cfg, 48, 8, device="cpu")
    flat.copy_from(kv, [b for bl in bm.allocs.values() for b in bl],
                   [b for bl in bm.allocs.values() for b in bl])
    blocks = bm.allocs[2]

    def same(ids, a=kv, b=flat):
        x, y = a.read_blocks(ids)["0"], b.read_blocks(ids)["0"]
        for p in ("k", "v"):
            assert x[p].shape[-2] == cfg.n_kv_heads
            assert torch.equal(x[p], y[p])

    same(blocks)
    spare = bm.shard_free[bm.shard_of(blocks[2])][0]
    kv.copy_within(blocks[2], spare)
    flat.copy_within(blocks[2], spare)
    same([spare] + blocks)
    host = kv.read_blocks(blocks)
    dst = [bm.shard_free[i % 4][1 + i // 4] for i in range(len(blocks))]

    class Host:
        pools = host
    kv.copy_from(Host, range(len(blocks)), dst)
    flat.copy_from(Host, range(len(blocks)), dst)
    same(dst + blocks)
    other = PagedKVCache(cfg, 48, 8, kv_shards=4, mesh=kv.mesh,
                         shard_axis="data", head_axis="model")
    other.copy_from(kv, blocks, blocks)                # position-local
    same(blocks, other, flat)
    back = PagedKVCache(cfg, 48, 8, kv_shards=4, mesh=kv.mesh,
                        shard_axis="data", head_axis="model")
    back.copy_from(flat, dst, blocks)                  # flat -> sharded
    same(blocks, back, flat)


# --------------------------------------------------- TP x SP engine (2 x 2)
def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, L).astype(np.int32) for L in (64, 56)]


def _run(Eng, Req, sim, cp, table1, cfg, params, prompts, restripes=(),
         **kw):
    spec = sim.ClusterSpec(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4))
    eng = Eng(cfg, params, spec,
              _two_chunk(sim, cp, parallel=True)(table1(), spec),
              max_batch=4, max_seq=128, block_size=16, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Req(rid=i, arrival=i * 0.001, prompt_len=len(p),
                       output_len=OUT), p)
    for n, at in restripes:
        eng.request_restripe(n, at=at)
    return eng, eng.serve()


@pytest.fixture(scope="module")
def tp_runs(reduced_params_cache):
    jcfg, jp = reduced_params_cache("llama3-8b")
    cfg = get_config("llama3-8b").reduced()
    params = params_from_numpy(jp, cfg, device="cpu")
    prompts = _prompts(cfg.vocab_size)
    ctx = make_context(make_mesh((2, 2), ("data", "model"), device="cpu"),
                       "serve_paged")

    def port(**kw):
        return _run(TEngine, TRequest, t_sim, t_cp, t_table1, cfg, params,
                    prompts, ctx=ctx, **kw)

    eng, outs = port()
    tt = eng.reqs[0].token_times
    el, outs_el = port(restripes=[(1, None), (2, 0.5 * (tt[2] + tt[3]))])
    return dict(cfg=cfg, ctx=ctx, eng=eng, outs=outs, elastic=el,
                outs_elastic=outs_el,
                ref=_run(JEngine, JRequest, j_sim, j_cp, j_table1, jcfg, jp,
                         prompts)[1])


def test_tp_sp_engine_matches_reference_engine(tp_runs):
    """The 2 x 2 engine: pools striped over "data" and head-sharded over
    "model" (KVH 4 over 2), chunks through ring attention and ring-paged
    prefill per head slice, ticks through the split-KV decode per head
    slice; token for token the reference's single-device engine."""
    eng, cfg = tp_runs["eng"], tp_runs["cfg"]
    assert tp_runs["ctx"].tp_axis == "model"
    for kv, bm in ((eng.pkv, eng.pblocks),
                   (eng.dstates[0].kv, eng.dstates[0].blocks)):
        assert kv.kv_shards == 2 and kv.kv_head_shards == 2
        assert bm.kv_head_shards == 2
        shard = kv.pools["0"]["k"][0]
        assert len(shard) == 2 and shard[0].shape[-2] == cfg.n_kv_heads // 2
    for r in eng.reqs.values():
        assert [sp for _, sp in r.chunk_plan] == [1, 2], r.chunk_plan
    assert tp_runs["outs"] == tp_runs["ref"]


def test_tp_sp_engine_live_restripe_matches_reference_engine(tp_runs):
    """The same engine narrowed to one active shard before any prefill
    and widened to 2 mid-decode: the head-sharded pools move each head
    slice within its stripe, drain-free, and the tokens stay the
    reference engine's."""
    el = tp_runs["elastic"]
    log = el.restripe_log
    assert [e["n_new"] for e in log] == [1, 2], log
    assert log[0]["migrated_blocks"] == 0 and log[1]["migrated_blocks"] > 0
    assert not el.preempt_log and el.stall_ticks == 0
    assert tp_runs["outs_elastic"] == tp_runs["ref"]
