"""The KV fabric across two decode instances against the reference engine
on the CPU, on one device and on a 4-position mesh.

The cases of the reference's tests/test_kv_fabric.py:58-226, each on its
own trace with bridged weights:

* A — placed swap-in: a victim swapped out of instance 0 resumes on
  instance 1, which rid 1 has emptied;
* B — borrowed headroom: an instance short of its watermark floor
  borrows the other's headroom instead of preempting;
* C — peer prefix promotion: a twin admitted to instance 1 promotes the
  96-token chain resident on instance 0 instead of recomputing it.

On one device each case holds every record of tests/test_torch_tiers.py
equal between the engines and makes the reference test's assertions on
the port.  Then dist_progs/kv_fabric_prog.py's three scenarios run on
``make_context(mesh, "serve_paged")``, both decode pools and the prefill
pool striped 4 ways (a placed swap-in reads each shard's pages to the
host and scatters them back per shard; a peer promotion gathers out of
one striped pool into the striped prefill pool), held to the same
reference runs: greedy tokens do not depend on the schedule, and where
the striped books see what one device's see (A, C) the swap counters
with the fabric rollup, the preemption log, each instance's transfer
books and the placements are the reference's too.  B's are not: a
striped pool's headroom is what its shards can commit
(``BlockManager.effective_free``), so on B's trace the mesh also places
a swap victim and preempts once.  The mesh runs B on the prog's own
trace (pools of 24 pages), where one device has room and the mesh
borrows: the reference engine serves that trace too, the port's
one-device engine holds every record equal to it, and the mesh holds
its tokens, and greedy decoding's, as the prog does.  The runs a case
only compares against run on the port alone."""

import numpy as np
import pytest

from port_fixtures import one_torch_thread  # noqa: F401
from repro_torch.launch.mesh import make_context, make_mesh
from test_torch_tiers import (P, _assert_records, _greedy,  # noqa: F401
                              _serve, reference_compile_cache)


def _placed_swap(P, mesh):
    rng = np.random.default_rng(31)
    vocab = P["port"][0].vocab_size
    prompts = [rng.integers(0, vocab, 64).astype(np.int32)
               for _ in range(3)]
    jobs = [(i, i * 0.005, prompts[i], out)
            for i, out in enumerate((24, 18, 16))]
    kw = dict(n_decode=2, max_batch=1, max_seq=128, preempt_policy="swap",
              pcie_bw=1e8)
    calm = _serve(P, "port", jobs, **kw)
    tt = calm.reqs[0].token_times
    kw["preempt"] = ((0, 0.5 * (tt[5] + tt[6])),)
    return {"calm": calm, "ref": _serve(P, "ref", jobs, **kw),
            "port": _serve(P, "port", jobs, **kw),
            "mesh": _serve(P, "port", jobs, ctx=mesh, **kw)}


def _borrow(P, mesh):
    rng = np.random.default_rng(47)
    vocab = P["port"][0].vocab_size
    pa = rng.integers(0, vocab, 60).astype(np.int32)
    pb = rng.integers(0, vocab, 100).astype(np.int32)
    pc = rng.integers(0, vocab, 60).astype(np.int32)
    jobs = [(0, 0.0, pa, 30), (1, 0.005, pb, 4), (2, 0.01, pc, 30)]
    kw = dict(n_decode=2, max_batch=2, max_seq=128, preempt_watermark=0.3)
    # the prog's trace: its scenario A's three prompts drawn first
    rng = np.random.default_rng(42)
    for _ in range(3):
        rng.integers(0, vocab, 64)
    prog = [(i, i * 0.005, rng.integers(0, vocab, L).astype(np.int32), o)
            for i, (L, o) in enumerate(((64, 30), (96, 4), (64, 30)))]
    kw_prog = dict(n_decode=2, max_batch=2, max_seq=192,
                   preempt_watermark=0.3)
    return {"off": _serve(P, "port", jobs, fabric="off", **kw),
            "ref": _serve(P, "ref", jobs, fabric="auto", **kw),
            "port": _serve(P, "port", jobs, fabric="auto", **kw),
            "prog": prog, "prog_ref": _serve(P, "ref", prog, **kw_prog),
            "flat": _serve(P, "port", prog, **kw_prog),
            "mesh": _serve(P, "port", prog, ctx=mesh, **kw_prog)}


def _peer_promotion(P, mesh):
    rng = np.random.default_rng(53)
    vocab = P["port"][0].vocab_size
    base = rng.integers(0, vocab, 104).astype(np.int32)
    twin = base.copy()
    twin[96:] = rng.integers(0, vocab, 8)

    def jobs(arrival):
        return [(0, 0.0, base, 60), (1, arrival, twin, 8)]

    kw = dict(n_decode=2, max_batch=2, max_seq=256)
    probe = _serve(P, "port", jobs(30.0), fabric="off", **kw)
    early = probe.reqs[0].token_times[2]
    return {"off": _serve(P, "port", jobs(early), fabric="off", **kw),
            "ref": _serve(P, "ref", jobs(early), fabric="auto", **kw),
            "port": _serve(P, "port", jobs(early), fabric="auto", **kw),
            "mesh": _serve(P, "port", jobs(early), ctx=mesh, **kw),
            "plen": len(base)}


@pytest.fixture(scope="module")
def runs(P):
    mesh = make_context(make_mesh((4,), ("data",), device="cpu"),
                        "serve_paged")
    return {"A": _placed_swap(P, mesh), "B": _borrow(P, mesh),
            "C": _peer_promotion(P, mesh)}


# --------------------------------------------------------- one device
def test_fabric_places_swap_victim_on_peer_instance(runs):
    """tests/test_kv_fabric.py:58 — a victim swapped out of a full
    instance resumes on the emptied peer, token for token."""
    r = runs["A"]
    _assert_records(r["port"], r["ref"])
    calm, eng = r["calm"], r["port"]
    assert calm.reqs[0].decode_instance == 0
    st_ = eng.swap_stats
    fab = st_["fabric"]
    assert fab["swap_in_placed"] >= 1 and fab["interconnect_bytes"] > 0
    assert eng.reqs[0].decode_instance == 1
    places = eng.tracer.entries("swap_place")
    assert places and places[0]["origin"] == 0 and places[0]["target"] == 1
    assert eng.dstates[1].transfers.stats["ic_placed_moves"] >= 1
    assert eng.dstates[1].transfers.stats["ic_placed_bytes"] > 0
    pi = st_["per_instance"]
    assert pi[1]["swap_in_placed"] >= 1 and pi[0]["swap_outs"] >= 1
    assert sum(p["swap_ins"] for p in pi.values()) == st_["swap_ins"]
    assert eng.outputs == calm.outputs
    for d, inst in zip(eng.dstates, eng.decodes):
        assert d.blocks.n_free == d.blocks.total_blocks
        assert inst.swapped_tokens == 0 and inst.swap_in_flight == 0
    assert st_["swapped_now"] == 0 and st_["swap_outs"] == st_["swap_ins"]


def test_fabric_borrow_avoids_watermark_preempt(runs):
    """tests/test_kv_fabric.py:109 — a watermark shortfall borrows an
    idle donor's headroom instead of preempting; every lease comes
    back."""
    r = runs["B"]
    _assert_records(r["port"], r["ref"])
    off, on = r["off"], r["port"]
    assert off.reqs[0].decode_instance == off.reqs[2].decode_instance
    assert off.preempt_log and "fabric" not in off.swap_stats
    assert on.fabric.cross_instance and on.preempt_log == []
    fab = on.swap_stats["fabric"]
    assert fab["leases_out"] >= 1 and fab["lease_blocks_out"] >= 1
    assert fab["leases_recalled"] == fab["leases_out"]
    assert fab["lease_blocks_recalled"] == fab["lease_blocks_out"]
    assert on.fabric.leased_blocks == 0
    donor = 1 - on.reqs[0].decode_instance
    assert on.dstates[donor].transfers.stats["ic_lease_moves"] >= 1
    assert on.swap_stats["per_instance"][donor]["lent_blocks"] == 0
    reg = on.metrics.snapshot()["counters"]
    assert reg["fabric/leases_out"] == fab["leases_out"]
    assert reg["fabric/leases_recalled"] == fab["leases_recalled"]
    assert on.metrics.gauge("fabric/leases_active").value == 0
    assert on.outputs == off.outputs
    for d in on.dstates:
        assert d.blocks.n_free == d.blocks.total_blocks
        assert not d.blocks.leases


def test_fabric_promotes_peer_resident_prefix(runs):
    """tests/test_kv_fabric.py:170 — a twin admitted to the other
    instance promotes the resident base's 96-token chain over the
    interconnect instead of recomputing it."""
    r = runs["C"]
    _assert_records(r["port"], r["ref"])
    off, on = r["off"], r["port"]
    assert off.reqs[0].done > off.reqs[1].transfer_done
    assert off.reqs[1].decode_instance != off.reqs[0].decode_instance
    fab = on.swap_stats["fabric"]
    assert fab["peer_promotions"] >= 1 and fab["peer_promoted_blocks"] >= 4
    assert fab["interconnect_bytes"] > 0
    src = on.reqs[0].decode_instance
    assert on.reqs[1].decode_instance != src
    assert on.dstates[src].transfers.stats["ic_peer_promote_moves"] >= 1
    assert on.dstates[src].transfers.stats["ic_peer_promote_bytes"] > 0
    assert on.swap_stats["per_instance"][src]["peer_promotions_src"] >= 1
    planned_on = sum(c[0] for c in on.reqs[1].chunk_plan)
    planned_off = sum(c[0] for c in off.reqs[1].chunk_plan)
    assert planned_on <= planned_off - 4 * 16
    assert on.planner_promotions >= 4
    assert on.outputs == off.outputs


# ----------------------------------------------------------- the mesh
def _striped_and_drained(eng):
    for d in eng.dstates:
        assert d.kv_shards == 4 and d.blocks.kv_shards == 4
        assert isinstance(d.kv.pools["0"]["k"], list)
        assert d.blocks.n_free == d.blocks.total_blocks
        assert not d.blocks.leases
    assert eng.pkv.kv_shards == 4
    assert eng.pblocks.n_free == eng.pblocks.total_blocks
    assert eng.swap_stats["swapped_now"] == 0


@pytest.mark.parametrize("scenario", ["A", "B", "C"])
def test_mesh_fabric_matches_reference_engine(P, runs, scenario):
    """A and C on the striped pools give the reference engine's tokens,
    swap counters, fabric rollup, per-instance breakdown, preemption log,
    transfer books and placements; B (the module docstring) gives the
    reference engine's tokens on the prog's trace, where the port's
    one-device engine matches every record of the reference's, and
    greedy decoding's."""
    r = runs[scenario]
    port = r["mesh"]
    _striped_and_drained(port)
    if scenario == "B":
        flat, ref = r["flat"], r["prog_ref"]
        _assert_records(flat, ref)
        assert ref.swap_stats["fabric"]["leases_out"] == 0
        assert port.outputs == ref.outputs
        for rid, _, prompt, _ in r["prog"]:
            out = port.outputs[rid]
            assert out == _greedy(P, prompt, len(out))
        return
    ref = r["ref"]
    assert port.outputs == ref.outputs
    assert port.swap_stats == ref.swap_stats
    assert port.preempt_log == ref.preempt_log
    assert [d.transfers.stats for d in port.dstates] == \
        [d.transfers.stats for d in ref.dstates]
    assert port.tracer.entries("swap_place") == \
        ref.tracer.entries("swap_place")


def test_mesh_placed_swap_in(runs):
    """Scenario A on the mesh: the victim resumes off its origin, token
    for token the calm run."""
    eng = runs["A"]["mesh"]
    fab = eng.swap_stats["fabric"]
    assert fab["swap_in_placed"] >= 1
    assert eng.reqs[0].decode_instance == 1
    assert eng.dstates[1].transfers.stats["ic_placed_moves"] >= 1
    assert eng.outputs == runs["A"]["calm"].outputs


def test_mesh_borrowed_growth(runs):
    """Scenario B on the mesh: the shortfall borrows, every lease comes
    back, nothing is preempted."""
    eng = runs["B"]["mesh"]
    assert eng.reqs[0].decode_instance == eng.reqs[2].decode_instance
    fab = eng.swap_stats["fabric"]
    assert fab["leases_out"] >= 1
    assert fab["leases_recalled"] == fab["leases_out"]
    assert eng.preempt_log == [] and eng.fabric.leased_blocks == 0


def test_mesh_peer_prefix_promotion(runs):
    """Scenario C on the mesh: the twin promotes the peer chain out of
    instance 0's striped pool and skips its tokens in the prefill
    plan."""
    eng = runs["C"]["mesh"]
    fab = eng.swap_stats["fabric"]
    assert fab["peer_promotions"] >= 1 and fab["peer_promoted_blocks"] >= 4
    assert eng.reqs[1].decode_instance != eng.reqs[0].decode_instance
    assert sum(c[0] for c in eng.reqs[1].chunk_plan) \
        <= runs["C"]["plen"] - 4 * 16
