"""The port's KV memory tiers against the reference engine on the CPU.

The cases of the reference's tests/test_kv_offload.py (swap to the host
tier, the ``auto`` policy, one gather a release, swap-in re-sharing, the
host prefix cache), the one-instance case of tests/test_kv_fabric.py
(its two-instance cases are in tests/test_torch_tiers_mesh.py) and
tests/test_prefix_sharing.py (block sharing, copy-on-write, decode-grown
blocks, prefill backpressure), with the same traces and bridged weights,
and the page helpers of tests/test_paged_engine.py.

Each engine case runs the trace the reference test asserts on through
both engines and holds every record equal (``_records``): outputs,
``chunk_log``, ``preempt_log``, ``mixed_stats``, ``swap_stats`` (with its
``fabric`` and ``per_instance`` parts), each decode instance's block and
transfer books, and the tracer's ``swap_place`` entries.  Then it makes
the reference test's own assertions on the port's engine.  The runs a
reference test only compares against (calm runs, solo runs, the
sharing-off or fabric-off twins) run on the port alone: the reference
engine compiles every forward anew (about half a second each here,
less where ``reference_compile_cache`` finds the shape), so one
reference run per case is what the suite can afford.  The engine
clock is modelled, so the port's calm runs time the preemptions exactly
as the reference's would."""

import inspect

import numpy as np
import pytest
import torch

import repro.serving.kv_offload as j_off
import repro_torch.serving.kv_offload as t_off
from repro.core import latency_model as j_lm
from repro_torch.configs.registry import get_config
from repro_torch.core import latency_model as t_lm
from repro_torch.models.params import params_from_numpy
from repro_torch.models.sharding import CPU_CTX
from repro_torch.models.transformer import forward
from port_fixtures import (one_torch_thread,  # noqa: F401
                           reference_compile_cache)
from test_torch_engine import SIDES, _two_chunk

LM = {"ref": j_lm, "port": t_lm}


@pytest.fixture(scope="module")
def P(reduced_params_cache, reference_compile_cache):
    """{side: (cfg, params)}: reduced yi-9b, the port's weights bridged
    from the reference's (the reference's forwards cached for the
    module)."""
    jcfg, jp = reduced_params_cache("yi-9b")
    cfg = get_config("yi-9b").reduced()
    return {"ref": (jcfg, jp),
            "port": (cfg, params_from_numpy(jp, cfg, device="cpu"))}


def _serve(P, side, jobs, *, n_decode=1, preempt=(), pcie_bw=None,
           ctx=None, **kw):
    """One engine over ``jobs`` [(rid, arrival, prompt, output_len)] with
    the reference tests' ParallelTwoChunkPolicy and ``n_decode`` decode
    instances; ``pcie_bw`` sets a HostOffloadModel with no base cost;
    ``ctx`` replaces the port's CPU context (a mesh)."""
    Eng, Req, sim, cp, table1, extra = SIDES[side]
    if ctx is not None:
        extra = {"ctx": ctx}
    cfg, params = P[side]
    spec = sim.ClusterSpec(n_prefill=8, n_decode=n_decode,
                           sp_candidates=(1, 2, 4))
    if pcie_bw is not None:
        kw["offload_model"] = LM[side].HostOffloadModel(pcie_bw=pcie_bw,
                                                        base=0.0)
    kw = {"max_batch": 4, "block_size": 16, **kw}
    eng = Eng(cfg, params, spec,
              _two_chunk(sim, cp, parallel=True)(table1(), spec),
              **kw, **extra)
    for rid, arrival, prompt, out in jobs:
        eng.submit(Req(rid=rid, arrival=arrival, prompt_len=len(prompt),
                       output_len=out), prompt)
    for rid, at in preempt:
        eng.preempt(rid, at=at)
    eng.serve()
    return eng


def _records(eng) -> dict:
    return {"outputs": eng.outputs, "chunk_log": eng.chunk_log,
            "preempt_log": eng.preempt_log, "mixed_stats": eng.mixed_stats,
            "swap_stats": eng.swap_stats,
            "blocks": [d.blocks.stats for d in eng.dstates],
            "transfers": [d.transfers.stats for d in eng.dstates],
            "swap_place": eng.tracer.entries("swap_place")}


def _assert_records(port, ref) -> None:
    got, want = _records(port), _records(ref)
    for key in want:
        assert got[key] == want[key], key


def _both(P, jobs, **kw):
    """The trace through both engines, every record held equal; returns
    the port's engine."""
    port = _serve(P, "port", jobs, **kw)
    _assert_records(port, _serve(P, "ref", jobs, **kw))
    return port


def _greedy(P, prompt, n):
    """Greedy decoding with whole forwards on the port (the reference
    tests' dense oracle)."""
    cfg, params = P["port"]
    toks = list(prompt)
    for _ in range(n):
        pos = torch.arange(len(toks), dtype=torch.int32)[None]
        logits, _, _ = forward(params, cfg, CPU_CTX, torch.tensor([toks]),
                               pos, "train")
        toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab_size])))
    return toks[len(prompt):]


def _batch_jobs(vocab, n_req=3, prompt_len=60, output_len=12):
    """tests/test_kv_offload.py's ``_serve_batch`` trace."""
    rng = np.random.default_rng(21)
    return [(i, i * 0.005,
             rng.integers(0, vocab, prompt_len).astype(np.int32),
             output_len) for i in range(n_req)]


@pytest.fixture(scope="module")
def batch(P):
    """The block-pressure trace's calm run (port) and its swap run (both
    engines, records equal), shared by the offload and fabric cases."""
    jobs = _batch_jobs(P["port"][0].vocab_size)
    return {"jobs": jobs,
            "calm": _serve(P, "port", jobs, max_seq=128,
                           preempt_policy="recompute"),
            "tight": _both(P, jobs, max_seq=48, preempt_policy="swap")}


def _assert_swap_drained(eng):
    bm = eng.dstates[0].blocks
    assert bm.n_free == bm.total_blocks and not bm.allocs
    assert not bm.virtual_tokens and not bm.tokens_of
    inst = eng.decodes[0]
    assert inst.slots_free == eng.spec.cache_slots
    assert inst.swapped_tokens == 0 and inst.swap_in_flight == 0
    st_ = eng.swap_stats
    assert st_["swapped_now"] == 0
    assert st_["swap_outs"] == st_["swap_ins"]
    assert st_["host_blocks_in_use"] == len(eng.host_cache)


def _assert_drained(eng):
    bm = eng.dstates[0].blocks
    assert bm.n_free == bm.total_blocks and not bm.allocs and not bm.ref
    assert not bm.by_hash and not bm.hash_of
    assert eng.pblocks.n_free == eng.pblocks.total_blocks
    inst = eng.decodes[0]
    assert inst.shared_tokens == 0
    assert inst.slots_free == eng.spec.cache_slots


# ------------------------------------------------------- offload: engine
def test_swap_preemption_bit_identical(batch):
    """tests/test_kv_offload.py:60 — swap victims resume token for token
    with no recomputed prefill token."""
    calm, tight = batch["calm"], batch["tight"]
    assert calm.preempt_log == []
    assert tight.preempt_log
    assert all(e["policy"] == "swap" for e in tight.preempt_log)
    assert all(e["resume_tokens"] == 0 for e in tight.preempt_log)
    for e in tight.preempt_log:
        assert e["swap_in_ms"] > 0.0 and e["recompute_ms"] > 0.0
    st_ = tight.swap_stats
    assert st_["swap_outs"] >= 1 and st_["bytes_out"] > 0
    assert st_["bytes_in"] >= st_["bytes_out"] > 0
    for rid in {e["rid"] for e in tight.preempt_log}:
        assert len(tight.reqs[rid].chunk_plan) == 2
        assert tight.reqs[rid].preemptions >= 1
    for rid in calm.outputs:
        assert tight.outputs[rid] == calm.outputs[rid]
        assert tight.reqs[rid].done is not None
        assert tight.reqs[rid].phase.name == "DONE"
    _assert_swap_drained(tight)


@pytest.mark.parametrize("pcie_bw,policy", [(1e15, "swap"),
                                            (1e3, "recompute")])
def test_auto_policy_end_to_end(P, batch, pcie_bw, policy):
    """tests/test_kv_offload.py:92 — ``auto`` follows the modelled costs:
    a free PCIe swaps, a glacial one recomputes; outputs equal the calm
    run's either way."""
    eng = _both(P, batch["jobs"], max_seq=48, preempt_policy="auto",
                pcie_bw=pcie_bw)
    assert eng.preempt_log
    assert all(e["policy"] == policy for e in eng.preempt_log)
    if policy == "recompute":
        assert eng.swap_stats["swap_outs"] == 0
    else:
        assert eng.swap_stats["swap_outs"] >= 1
    assert eng.outputs == batch["calm"].outputs


# ---------------------------------------------------- offload: cost model
def _choose(side, n_blocks, bs, bpt, L, *, d, **kw):
    """One package's ``choose_preempt_policy`` under the reference tests'
    synthetic models: PCIe at 1e9 B/s, prefill b = 1e-7, quadratic d."""
    lm = LM[side]
    off = lm.HostOffloadModel(pcie_bw=1e9, base=0.0)
    pm = lm.PrefillLatencyModel({1: lm.SPCoeffs(a=0.0, b=1e-7, c=0.0, d=d)})
    mod = j_off if side == "ref" else t_off
    return mod.choose_preempt_policy(n_blocks, bs, bpt, L, pm, off, **kw)


def _choose_both(*args, **kw):
    got = _choose("port", *args, **kw)
    assert got == _choose("ref", *args, **kw)
    return got


def test_auto_policy_cost_crossovers():
    """tests/test_kv_offload.py:115-160 — short prefixes recompute, long
    ones swap; host-cached tokens discount the recompute side and flip
    the verdict; both packages give the same (policy, swap_ms,
    recompute_ms) bit for bit."""
    pol, swap_ms, rec_ms = _choose_both(2, 16, 1024.0, 32, d=1e-8)
    assert pol == "recompute" and rec_ms < swap_ms
    pol, swap_ms, rec_ms = _choose_both(100_000 // 16, 16, 1024.0, 100_000,
                                        d=1e-8)
    assert pol == "swap" and swap_ms < rec_ms
    assert swap_ms > 0.0 and rec_ms > 0.0
    L = 100_000
    args = (L // 16, 16, 4096.0, L)
    pol, swap0, rec0 = _choose_both(*args, d=5e-11)
    assert pol == "swap" and swap0 < rec0
    pol, swap1, rec1 = _choose_both(*args, d=5e-11, cached_tokens=L // 2)
    assert swap1 == swap0 and rec1 < rec0 and pol == "recompute"
    _, _, rec2 = _choose_both(*args, d=5e-11, cached_tokens=3 * L // 4)
    assert rec2 < rec0


def test_preempt_policy_queue_depth_crossover():
    """tests/test_kv_offload.py:325 — the destination's queue term adds
    exactly depth x tick to the swap side and flips the verdict past the
    crossover."""
    args = (100_000 // 16, 16, 1024.0, 100_000)
    pol0, swap0, rec0 = _choose_both(*args, d=1e-8)
    assert pol0 == "swap" and swap0 < rec0
    _, swap_idle, _ = _choose_both(*args, d=1e-8, queue_depth=0,
                                   queue_ms=5.0)
    assert swap_idle == swap0
    depth = int(np.ceil((rec0 - swap0) / 5.0)) + 1
    pol1, swap1, rec1 = _choose_both(*args, d=1e-8, queue_depth=depth,
                                     queue_ms=5.0)
    assert swap1 == swap0 + depth * 5.0 and rec1 == rec0
    assert pol1 == "recompute"
    below = int((rec0 - swap0) // 5.0) - 1
    pol2, _, _ = _choose_both(*args, d=1e-8, queue_depth=max(below, 0),
                              queue_ms=5.0)
    assert pol2 == "swap"


# ------------------------------------------------------- offload: engine
def test_release_demotes_all_blocks_in_one_gather(P):
    """tests/test_kv_offload.py:161 — a finishing request's published
    blocks demote through one batched gather."""
    rng = np.random.default_rng(71)
    prompt = rng.integers(0, P["port"][0].vocab_size, 96).astype(np.int32)
    eng = _both(P, [(0, 0.0, prompt, 6)], max_seq=256)
    st_ = eng.swap_stats
    assert st_["demotions"] >= 6
    assert st_["demote_gathers"] == 1
    assert st_["demote_gathers"] < st_["demotions"]


def test_swap_in_reshares_twin_prefix(P):
    """tests/test_kv_offload.py:183 — a swap victim whose twin still holds
    the prefix commits the shared blocks by reference at swap-in."""
    rng = np.random.default_rng(83)
    prompt = rng.integers(0, P["port"][0].vocab_size, 64).astype(np.int32)
    jobs = [(0, 0.0, prompt, 14), (1, 0.001, prompt.copy(), 14)]
    kw = dict(max_seq=256, preempt_policy="swap")
    calm = _serve(P, "port", jobs, prefix_sharing=True, **kw)
    tt = calm.reqs[1].token_times
    pre = ((1, 0.5 * (tt[3] + tt[4])),)
    eng = _both(P, jobs, prefix_sharing=True, preempt=pre, **kw)
    st_ = eng.swap_stats
    assert st_["swap_outs"] >= 1 and st_["swap_ins"] >= 1
    assert st_["swap_in_shared_blocks"] >= 4
    unshared = _serve(P, "port", jobs, prefix_sharing=False, preempt=pre,
                      **kw)
    bm_s, bm_u = eng.dstates[0].blocks, unshared.dstates[0].blocks
    assert bm_s.peak_in_use < bm_u.peak_in_use
    assert bm_s.stats["fresh"] < bm_u.stats["fresh"]
    for rid in calm.outputs:
        assert eng.outputs[rid] == calm.outputs[rid] \
            == unshared.outputs[rid]
    _assert_swap_drained(eng)


def test_engine_rejects_bad_offload_config(P):
    """tests/test_kv_offload.py:230."""
    Eng, _, sim, cp, table1, extra = SIDES["port"]
    cfg, params = P["port"]
    spec = sim.ClusterSpec(n_prefill=8, n_decode=1, sp_candidates=(1, 2, 4))
    pol = _two_chunk(sim, cp, parallel=True)(table1(), spec)
    with pytest.raises(ValueError, match="preempt_policy"):
        Eng(cfg, params, spec, pol, preempt_policy="drop", **extra)
    with pytest.raises(ValueError, match="host"):
        Eng(cfg, params, spec, pol, preempt_policy="swap",
            host_pool_blocks=0, **extra)


# ----------------------------------------------- offload: the host tier
def _tiny_cfg():
    """tests/test_kv_offload.py's ``_tiny_cfg``: 2 blocks, 2 KV heads of 4."""
    from types import SimpleNamespace
    return SimpleNamespace(pattern=[SimpleNamespace(mixer="attn")],
                           n_blocks=2, n_kv_heads=2, head_dim_=4,
                           dtype="float32")


def _pages(rng, n, page):
    return {"0": {p: rng.standard_normal((2, n, page, 2, 4)).astype(
        np.float32) for p in ("k", "v")}}


def _as_torch(data):
    return {l: {p: torch.as_tensor(a) for p, a in parts.items()}
            for l, parts in data.items()}


def test_host_pool_round_trip_matches_reference():
    """The accounting and bytes of ``HostKVPool`` (the invariants of
    tests/test_kv_offload.py's round-trip property) over a seeded run of
    alloc / store / load / free: the port's pool gives the reference's
    free list and peak after every step, and every load returns exactly
    the bytes stored."""
    cfg, page, total = _tiny_cfg(), 4, 6
    pools = {"ref": j_off.HostKVPool(cfg, total_blocks=total,
                                     block_size=page),
             "port": t_off.HostKVPool(cfg, total_blocks=total,
                                      block_size=page)}
    rng = np.random.default_rng(99)
    held = {}
    for _ in range(60):
        kind, tag, n = (int(rng.integers(0, 3)), int(rng.integers(0, 5)),
                        int(rng.integers(1, 4)))
        if kind == 0 and tag not in held:
            data = _pages(rng, n, page)
            got = pools["port"].alloc(n)
            assert got == pools["ref"].alloc(n)
            if got is None:
                assert n > pools["port"].n_free
                continue
            pools["ref"].store(got, data)
            pools["port"].store(got, _as_torch(data))
            held[tag] = (got, data)
        elif kind in (1, 2) and tag in held:
            blocks, data = held[tag] if kind == 2 else held.pop(tag)
            for part in ("k", "v"):
                np.testing.assert_array_equal(
                    pools["port"].pools["0"][part][:, blocks].numpy(),
                    data["0"][part])
            if kind == 1:
                pools["ref"].free(blocks)
                pools["port"].free(blocks)
        for attr in ("free_blocks", "peak_in_use", "n_free"):
            assert getattr(pools["port"], attr) == getattr(pools["ref"],
                                                           attr)
        used = [b for bl, _ in held.values() for b in bl]
        assert len(used) == len(set(used))
        assert not set(used) & set(pools["port"].free_blocks)
        assert pools["port"].n_free + len(used) == total
    assert pools["port"].pools["0"]["k"].dtype == torch.float32


def test_host_prefix_cache_lru_and_verification():
    """tests/test_kv_offload.py:299 — LRU eviction, token verification
    on a matching hash, a broken chain stops the match; the port's cache
    keeps the reference's stats."""
    caches = {}
    for side, mod, conv in (("ref", j_off, lambda d: d),
                            ("port", t_off, _as_torch)):
        cfg, page = _tiny_cfg(), 4
        cache = mod.HostPrefixCache(mod.HostKVPool(cfg, total_blocks=2,
                                                   block_size=page))
        rng = np.random.default_rng(5)
        toks = {h: [10 * h + j for j in range(page)] for h in (1, 2, 3)}
        for h in (1, 2, 3):
            assert cache.put(h, toks[h], conv(_pages(rng, 1, page)))
        assert len(cache) == 2 and cache.stats["evictions"] == 1
        assert 1 not in cache.entries
        seq = np.asarray(toks[2] + toks[3])
        assert len(cache.match_chain([2, 3], seq, 0, page)) == 2
        assert cache.match_chain([2], np.asarray([99] * page), 0,
                                 page) == []
        assert len(cache.match_chain([9, 3], seq, 0, page)) == 0
        cache.evict_until(2)
        assert cache.pool.n_free == 2 and len(cache) == 0
        caches[side] = cache
    assert caches["port"].stats == caches["ref"].stats


def test_host_prefix_cache_hit_after_eviction(P):
    """tests/test_kv_offload.py:358 — a twin arriving after its sibling
    left the card promotes the demoted chain from the host tier."""
    rng = np.random.default_rng(61)
    prompt = rng.integers(0, P["port"][0].vocab_size, 48).astype(np.int32)
    solo = _serve(P, "port", [(0, 0.0, prompt, 6)], max_seq=256)
    a_done = solo.reqs[0].done
    eng = _both(P, [(0, 0.0, prompt, 6),
                    (1, a_done + 0.5, prompt.copy(), 6)], max_seq=256)
    assert eng.reqs[1].arrival > eng.reqs[0].done
    st_ = eng.swap_stats
    assert st_["demotions"] >= 3
    assert st_["host_prefix_hits"] >= 3
    assert eng.dstates[0].transfers.stats["promotes"] >= 1
    assert eng.dstates[0].transfers.stats["promote_bytes"] > 0
    assert eng.outputs[0] == eng.outputs[1] == solo.outputs[0]


# ----------------------------------------------------------------- fabric
def test_fabric_off_is_byte_identical(P, batch):
    """tests/test_kv_fabric.py:33 — one instance: ``auto`` and ``off``
    keep the pre-fabric records; ``on`` pins every swap-in."""
    auto = batch["tight"]
    off = _serve(P, "port", batch["jobs"], max_seq=48,
                 preempt_policy="swap", fabric="off")
    assert not auto.fabric.cross_instance and not off.fabric.cross_instance
    assert "fabric" not in auto.swap_stats
    assert auto.swap_stats == off.swap_stats
    assert auto.preempt_log == off.preempt_log and auto.preempt_log
    assert auto.outputs == off.outputs
    on = _both(P, batch["jobs"], max_seq=48, preempt_policy="swap",
               fabric="on")
    assert on.fabric.cross_instance
    fab = on.swap_stats["fabric"]
    assert fab["swap_in_placed"] == 0 and fab["swap_in_pinned"] >= 1
    assert fab["leases_out"] == 0 and fab["peer_promotions"] == 0
    assert on.outputs == off.outputs
    with pytest.raises(ValueError, match="fabric"):
        _serve(P, "port", batch["jobs"], max_seq=48, fabric="sideways")


# ---------------------------------------------------------------- sharing
def test_shared_prefix_shares_blocks_outputs_bit_identical(P):
    """tests/test_prefix_sharing.py:56 — a second request reuses the
    first's full blocks of a common 48-token prefix."""
    rng = np.random.default_rng(31)
    vocab = P["port"][0].vocab_size
    common = rng.integers(0, vocab, 48).astype(np.int32)
    pa = np.concatenate([common, rng.integers(0, vocab, 16)]).astype(
        np.int32)
    pb = np.concatenate([common, rng.integers(0, vocab, 16)]).astype(
        np.int32)
    jobs = [(0, 0.0, pa, 12), (1, 0.01, pb, 6)]
    solo_a = _serve(P, "port", jobs[:1], max_seq=256)
    solo_b = _serve(P, "port", [(1, 0.0, pb, 6)], max_seq=256)
    unshared = _serve(P, "port", jobs, max_seq=256, prefix_sharing=False)
    shared = _both(P, jobs, max_seq=256, prefix_sharing=True)
    assert shared.reqs[1].transfer_done < shared.reqs[0].done
    bm = shared.dstates[0].blocks
    assert bm.stats["shared"] >= 3
    assert bm.stats["fresh"] < unshared.dstates[0].blocks.stats["fresh"]
    assert shared.outputs[0] == unshared.outputs[0] == solo_a.outputs[0]
    assert shared.outputs[1] == unshared.outputs[1] == solo_b.outputs[1]
    assert unshared.dstates[0].blocks.stats["shared"] == 0
    _assert_drained(shared)
    _assert_drained(unshared)


def test_cow_divergent_suffix_never_corrupts_sibling(P):
    """tests/test_prefix_sharing.py:87 — B's prompt ends inside A's third
    page, so B's first token lands in a shared page and splits it."""
    rng = np.random.default_rng(37)
    pa = rng.integers(0, P["port"][0].vocab_size, 56).astype(np.int32)
    pb = pa[:40].copy()
    solo_a = _serve(P, "port", [(0, 0.0, pa, 12)], max_seq=256)
    solo_b = _serve(P, "port", [(1, 0.0, pb, 8)], max_seq=256)
    shared = _both(P, [(0, 0.0, pa, 12), (1, 0.01, pb, 8)], max_seq=256,
                   prefix_sharing=True)
    assert shared.reqs[1].transfer_done < shared.reqs[0].done
    bm = shared.dstates[0].blocks
    assert bm.stats["shared"] >= 3 and bm.stats["cow"] >= 1
    assert shared.outputs[0] == solo_a.outputs[0]
    assert shared.outputs[1] == solo_b.outputs[1]
    _assert_drained(shared)


def test_decode_grown_blocks_shared_mid_decode(P):
    """tests/test_prefix_sharing.py:114 — blocks that fill during decode
    are published, and a request extending the twin's prompt with its
    generated tokens shares them."""
    rng = np.random.default_rng(53)
    prompt = rng.integers(0, P["port"][0].vocab_size, 32).astype(np.int32)
    solo_a = _serve(P, "port", [(0, 0.0, prompt, 48)], max_seq=256,
                    block_size=8)
    tt = solo_a.reqs[0].token_times
    pb = np.concatenate([prompt, np.asarray(solo_a.outputs[0][:8],
                                            prompt.dtype)])
    solo_b = _serve(P, "port", [(1, 0.0, pb, 6)], max_seq=256,
                    block_size=8)
    delay = solo_b.reqs[1].transfer_done - solo_b.reqs[1].arrival
    arrival = max(1e-3, tt[12] - delay)
    shared = _both(P, [(0, 0.0, prompt, 48), (1, arrival, pb, 6)],
                   max_seq=256, block_size=8)
    assert shared.reqs[1].transfer_done < shared.reqs[0].done
    assert shared.dstates[0].blocks.stats["shared"] >= 5
    assert shared.outputs[0] == solo_a.outputs[0]
    assert shared.outputs[1] == solo_b.outputs[1]
    _assert_drained(shared)


def test_admission_flow_has_no_dense_kv_tree():
    """tests/test_prefix_sharing.py:160 — the port's admission moves
    pages; it never builds a dense per-request KV tree."""
    import repro_torch.serving.engine as engine_mod
    src = inspect.getsource(engine_mod)
    assert "history_to_decode_caches(" not in src
    assert not hasattr(engine_mod, "history_to_decode_caches")
    assert "write_chunk" in src and "copy_from" in src


def test_combined_schedule_matches_dense_oracle(P):
    """tests/test_prefix_sharing.py:174 — two-chunk plans with an SP
    change, a preemption mid-prefill and one mid-decode: the tokens of
    the undisturbed run and of greedy decoding."""
    rng = np.random.default_rng(41)
    vocab = P["port"][0].vocab_size
    p0 = rng.integers(0, vocab, 64).astype(np.int32)
    p1 = rng.integers(0, vocab, 48).astype(np.int32)
    jobs = [(0, 0.0, p0, 5), (1, 0.02, p1, 6)]
    base = _serve(P, "port", jobs, max_seq=256)
    tt = base.reqs[1].token_times
    eng = _both(P, jobs, max_seq=256,
                preempt=((0, 1e-6), (1, 0.5 * (tt[2] + tt[3]))))
    assert eng.reqs[0].preemptions >= 1 and eng.reqs[1].preemptions >= 1
    assert any(e["reason"] == "manual" for e in eng.preempt_log)
    for rid, prompt in ((0, p0), (1, p1)):
        assert len(eng.reqs[rid].chunk_plan) >= 2
        assert len({sp for _, sp in eng.reqs[rid].chunk_plan}) >= 2
        out = eng.outputs[rid]
        assert out == base.outputs[rid] == _greedy(P, prompt, len(out))
    _assert_drained(eng)


def test_prefill_pool_backpressure_completes_and_matches(P):
    """tests/test_prefix_sharing.py:200 — five prefill pages for three
    concurrent four-page prefills: younger holders restart, every request
    completes with greedy decoding's tokens."""
    rng = np.random.default_rng(43)
    prompts = [rng.integers(0, P["port"][0].vocab_size, 64).astype(np.int32)
               for _ in range(3)]
    eng = _both(P, [(i, i * 0.001, p, 4) for i, p in enumerate(prompts)],
                max_seq=256, prefill_pool_blocks=5)
    assert any(r.preemptions > 0 for r in eng.reqs.values())
    for i, p in enumerate(prompts):
        assert eng.reqs[i].done is not None
        assert eng.outputs[i] == _greedy(P, p, len(eng.outputs[i]))
    assert eng.pblocks.n_free == eng.pblocks.total_blocks
    _assert_drained(eng)


# ----------------------------------------------------------- page helpers
def test_paged_gather_scatter_round_trip_matches_reference():
    """tests/test_paged_engine.py:321 — ``scatter_kv_prefill``,
    ``gather_kv_pages`` and ``scatter_kv_token`` of both packages on the
    same numpy pools, bit-equal, and the round trip's own checks."""
    import jax.numpy as jnp
    import repro.kernels.flash_decode as j_fd
    import repro_torch.kernels.flash_decode as t_fd
    rng = np.random.default_rng(0)
    nb, B, KVH, D, page, npg = 2, 3, 2, 8, 8, 4
    S = page * npg
    k = rng.standard_normal((nb, B, S, KVH, D)).astype(np.float32)
    jpool = jnp.zeros((nb, B * npg + 1, page, KVH, D), jnp.float32)
    tpool = torch.zeros(jpool.shape)
    perm = rng.permutation(B * npg)
    bt = np.zeros((B, npg), np.int32)
    for b in range(B):
        bt[b] = perm[b * npg:(b + 1) * npg]
        jpool = j_fd.scatter_kv_prefill(jpool, jnp.asarray(bt[b]),
                                        jnp.asarray(k[:, b]))
        t_fd.scatter_kv_prefill(tpool, torch.as_tensor(bt[b]),
                                torch.as_tensor(k[:, b]))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    dense = t_fd.gather_kv_pages(tpool, torch.as_tensor(bt))
    np.testing.assert_array_equal(dense.numpy(), k)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(j_fd.gather_kv_pages(jpool,
                                                       jnp.asarray(bt))))
    lengths = np.asarray([5, 17, 31], np.int32)
    new = rng.standard_normal((nb, B, KVH, D)).astype(np.float32)
    jpool = j_fd.scatter_kv_token(jpool, jnp.asarray(bt),
                                  jnp.asarray(lengths), jnp.asarray(new))
    t_fd.scatter_kv_token(tpool, torch.as_tensor(bt),
                          torch.as_tensor(lengths), torch.as_tensor(new))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    dense = t_fd.gather_kv_pages(tpool, torch.as_tensor(bt)).numpy()
    for b in range(B):
        np.testing.assert_array_equal(dense[:, b, lengths[b]], new[:, b])
        mask = np.ones(S, bool)
        mask[lengths[b]] = False
        np.testing.assert_array_equal(dense[:, b, mask], k[:, b, mask])
