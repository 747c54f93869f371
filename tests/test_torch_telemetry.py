"""The port's telemetry (``serving/telemetry.py``) against the reference's
on the CPU: the metrics registry, spans, TTFT attribution, TBT causes and
the Chrome trace export (tests/test_telemetry.py:42-258), then the
reference's two traced engine runs on both engines with bridged weights
(:260-465): attribution bit-equal to each TTFT and equal to the
reference's, tick conservation, closed spans, the log views, the rollups
against the per-instance gauges, the fabric counters against the
engine's logs, and the trace document.

``exact_remainder`` is held to the reference's on targets a float
remainder can reach (sums of the measured parts and a drawn remainder):
outside them both fall back to the naive remainder, which is not
bit-equal (ROADMAP Queue 3), so the reference's property test, which
draws targets freely, is not copied."""

import json
import time

import numpy as np
import pytest

import repro.serving.telemetry as j_tel
import repro_torch.serving.telemetry as t_tel
from repro_torch.configs.registry import get_config
from repro_torch.models.params import params_from_numpy
from port_fixtures import (one_torch_thread,  # noqa: F401
                           reference_compile_cache)
from test_torch_engine import SIDES, _mixed_two_chunk
from test_torch_tiers import LM, _records

TEL = {"ref": j_tel, "port": t_tel}


# ------------------------------------------------------------ pure metrics
def _registry(tel):
    m = tel.MetricsRegistry()
    m.counter("a").inc()
    m.counter("a").inc(2.5)
    m.gauge("g").set(3, t=0.5)
    m.gauge("g").set(7)
    for v in (1e-7, 1e-3, 1e-3 * 1.5, 2.0):
        m.hist("h").observe(v)
    return m


def test_registry_counters_gauges_hists():
    """tests/test_telemetry.py:42, and the port's snapshot is the
    reference's."""
    m = _registry(t_tel)
    snap = m.snapshot()
    assert snap == _registry(j_tel).snapshot()
    assert snap["counters"]["a"] == 3.5
    assert snap["gauges"]["g"] == 7.0
    assert m.gauge("g").samples == [(0.5, 3.0)]
    h = snap["histograms"]["h"]
    assert h["count"] == 4 and h["min"] == 1e-7 and h["max"] == 2.0
    assert "-1" in h["buckets"]
    assert m.hist("h").percentile(100) == 2.0
    assert 1e-3 <= m.hist("h").percentile(50) <= 2e-3


def test_exact_remainder_on_reachable_targets():
    """For targets ``fl(sum(measured) + q0)`` (a float remainder reaches
    them by construction) the port's remainder is the reference's and
    makes the left-to-right sum exactly the target; where no remainder
    reaches the target both return the same naive remainder."""
    rng = np.random.default_rng(7)
    for _ in range(500):
        measured = [float(v) for v in
                    rng.uniform(0.0, 10.0, int(rng.integers(0, 9)))]
        s = 0.0
        for v in measured:
            s += v
        target = s + float(rng.uniform(0.0, 100.0))
        q = t_tel.exact_remainder(target, measured)
        assert q == j_tel.exact_remainder(target, measured)
        assert s + q == target
    for target, measured in ((1e-300, [10.0]), (0.0, [1e300, 1.0])):
        assert t_tel.exact_remainder(target, measured) == \
            j_tel.exact_remainder(target, measured)


def test_op_profiler_disabled_and_enabled():
    """tests/test_telemetry.py:75: host wall clock where there is no card
    (the card's branch times by CUDA events, ``op_device_us``); and the
    phase clock: nothing at all when disabled, one sample a phase a
    handler when enabled, a phase's segments summed."""
    m = t_tel.MetricsRegistry()
    off = t_tel.OpProfiler(m, enabled=False)
    with off.op("x"):
        pass
    ph = off.phases("f")
    assert ph is off.phases("g")            # the one shared null clock
    ph.mark("prep")
    ph.end("post")
    assert "op_wall_us/x" not in m.hists
    assert not off.spans and not m.hists and off.to_chrome() == []
    on = t_tel.OpProfiler(m, enabled=True)
    with on.op("x"):
        pass
    on.collect(block=True)                  # nothing queued off the card
    assert m.hist("op_wall_us/x").count == 1
    assert not any(k.startswith("op_device_us/") for k in m.hists)
    ph = on.phases("f")
    ph.mark("prep")
    ph.mark("post")
    ph.mark("wait")
    ph.end("post")
    names = [n for n, _, _ in on.spans]
    assert names == ["f.prep", "f.post", "f.wait", "f.post", "f.launch"]
    for p in t_tel.PHASES:
        assert m.hist(f"host_us/f.{p}").count == 1
    assert m.hist("host_us/f.launch").total == 0.0
    post = sum(t1 - t0 for n, t0, t1 in on.spans if n == "f.post")
    assert m.hist("host_us/f.post").total == pytest.approx(post * 1e6)
    t_first, t_last = on.spans[0][1], on.spans[3][2]
    assert all(t_first <= t0 <= t1 <= t_last for _, t0, t1 in on.spans)
    xs = [e for e in on.to_chrome() if e["ph"] == "X"]
    assert [e["name"] for e in xs] == names
    assert {e["tid"] for e in xs} == {0}


# --------------------------------------------------------- tracer basics
def test_disabled_tracer_records_nothing():
    tr = t_tel.Tracer(enabled=False)
    tr.record(0.0, "arrive", rid=1)
    tr.begin("transfer", 1, 0.0)
    assert tr.events == [] and tr.open_spans() == {}


def test_span_pairing_and_end_all():
    tr = t_tel.Tracer()
    tr.begin("transfer", 1, 1.0, track=("request", 1))
    tr.begin("swap", 1, 2.0)
    tr.begin("transfer", 2, 3.0)
    assert set(tr.open_spans()) == {("transfer", 1), ("swap", 1),
                                    ("transfer", 2)}
    ev = tr.end("transfer", 1, 4.0)
    assert ev.t == 1.0 and ev.dur == 3.0 and ev.track == ("request", 1)
    tr.end_all(1, 5.0)
    assert set(tr.open_spans()) == {("transfer", 2)}
    assert tr.end("transfer", 9, 9.0) is None
    tr.end_all(2, 6.0)
    assert tr.open_spans() == {}


def test_entries_rebuild_in_record_order():
    tr = t_tel.Tracer()
    d0, d1 = {"t": 0.1, "x": 1}, {"t": 0.2, "x": 2}
    tr.record(0.1, "preempt", rid=0, entry=d0)
    tr.record(0.15, "tick", dur=0.01, rids=(0,), mode="standalone")
    tr.record(0.2, "preempt", rid=1, entry=d1)
    assert tr.entries("preempt") == [d0, d1]
    assert tr.entries("preempt")[0] is d0
    assert tr.entries("restripe") == []


# ------------------------------------------ attribution: seeded schedules
_KINDS = ["requeue", "preempt_swap", "preempt_recompute", "chunk",
          "transfer_begin", "admit", "swap_out", "swap_in_done"]


def _lifecycle(tel, rng):
    """tests/test_telemetry.py's ``_random_lifecycle`` from a seeded
    draw, recorded into a tracer of ``tel``; returns (tracer, t_last)."""
    tr = tel.Tracer()
    t = 0.0
    tr.record(0.0, "arrive", rid=0)
    for _ in range(int(rng.integers(0, 13))):
        k = _KINDS[int(rng.integers(0, 8))]
        t += float(rng.uniform(0.0, 0.3))
        dur = float(rng.uniform(0.0, 0.5))
        if k == "chunk":
            tr.record(t, "chunk", rid=0, dur=dur)
        elif k.startswith("preempt"):
            tr.record(t, "preempt", rid=0,
                      entry={"policy": k.split("_")[1]})
        else:
            tr.record(t, k, rid=0)
    return tr, t


def test_attribution_on_seeded_schedules_matches_reference():
    """tests/test_telemetry.py:143's lifecycles, drawn from a seed: the
    port attributes each TTFT exactly as the reference does, component
    for component, and every component but the remainder is >= 0."""
    for seed in range(200):
        comps = {}
        for side, tel in TEL.items():
            rng = np.random.default_rng(seed)
            tr, t_last = _lifecycle(tel, rng)
            done = t_last + float(rng.uniform(0.0, 0.4))
            comps[side] = tr.attribution(0, 0.0, done)
        assert comps["port"] == comps["ref"], seed
        assert set(comps["port"]) == set(t_tel.ATTRIBUTION_ORDER)
        for k in t_tel.ATTRIBUTION_ORDER:
            if k != "queue_wait":
                assert comps["port"][k] >= 0.0, (seed, k)
        assert t_tel.attribution_total(comps["port"]) == \
            j_tel.attribution_total(comps["ref"])


def test_attribution_components_land_where_expected():
    tr = t_tel.Tracer()
    tr.record(0.0, "arrive", rid=0)
    tr.record(1.0, "plan", rid=0)
    tr.record(1.0, "chunk", rid=0, dur=2.0)
    tr.record(4.0, "chunk", rid=0, dur=1.0)
    tr.record(5.0, "transfer_begin", rid=0)
    tr.record(7.0, "admit", rid=0)
    tr.record(8.0, "preempt", rid=0, entry={"policy": "swap"})
    tr.record(9.0, "swap_in_done", rid=0)
    comps = tr.attribution(0, 0.0, 9.5)
    assert comps["chunk_compute"] == 3.0
    assert comps["transfer"] == 2.0
    assert comps["swap_wait"] == 1.0
    assert comps["decode_resident"] == 1.5
    assert comps["preempt_requeue"] == 0.0
    assert t_tel.attribution_total(comps) == 9.5


def test_tbt_causes_priority_and_tick_modes():
    tr = t_tel.Tracer()
    for t, mode in [(0.0, "standalone"), (1.0, "fused"), (2.0, "standalone"),
                    (3.0, "standalone"), (4.0, "standalone")]:
        tr.record(t, "tick", track=("decode", 0), dur=0.1, rids=(7,),
                  mode=mode)
    tr.record(0.5, "swap", rid=7, dur=0.4)
    tr.record(1.5, "preempt", rid=7, entry={"policy": "recompute"})
    tr.record(2.5, "defer", track=("decode", 0), until=3.0)
    assert tr.tbt_causes(7) == ["swap", "preempt", "deferral", "standalone"]
    tr2 = t_tel.Tracer()
    tr2.record(0.0, "tick", track=("decode", 0), dur=0.1, rids=(1,),
               mode="standalone")
    tr2.record(1.0, "tick", track=("decode", 0), dur=0.1, rids=(1,),
               mode="fused")
    assert tr2.tbt_causes(1) == ["fused"]


def _chrome(tel):
    tr = tel.Tracer()
    tr.record(0.0, "arrive", rid=0, track=("request", 0))
    tr.record(0.1, "chunk", rid=0, dur=0.2, track=("prefill", 3), sp=2)
    tr.record(0.5, "tick", track=("decode", 1), dur=0.01, rids=(0,),
              mode="standalone", np_val=np.int64(3))
    tr.metrics.gauge("decode0/batch").set(2, t=0.5)
    return tr, tr.to_chrome()


def test_chrome_export_schema_and_event_count():
    """tests/test_telemetry.py:228, and the port's export is the
    reference's, event for event."""
    tr, out = _chrome(t_tel)
    assert json.dumps(out) == json.dumps(_chrome(j_tel)[1])
    assert len([e for e in out if e["ph"] in ("X", "i")]) == len(tr.events)
    for e in out:
        assert e["ph"] in ("M", "X", "i", "C")
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "M":
            assert e["name"] in ("process_name", "thread_name")
        else:
            assert "ts" in e
        if e["ph"] == "X":
            assert e["dur"] > 0
        if e["ph"] == "i":
            assert e["s"] == "t"
    assert sum(1 for e in out if e["ph"] == "C") == 1


def test_simulator_tracing_off_by_default():
    """tests/test_telemetry.py:449 on the port's simulator, whose traced
    run records the reference's events."""
    import repro.serving.simulator as j_sim
    import repro.serving.workload as j_wl
    import repro_torch.serving.simulator as t_sim
    import repro_torch.serving.workload as t_wl
    model = LM["port"].table1_model()
    spec = t_sim.ClusterSpec(n_prefill=4, n_decode=1)
    sim = t_sim.Simulator(spec, t_sim.make_policy("tetris", model, spec))
    sim.run(t_wl.make_trace("short", 0.5, 10.0, seed=0))
    assert sim.tracer.events == []
    sims = {}
    for side, sm, wl in (("ref", j_sim, j_wl), ("port", t_sim, t_wl)):
        spec2 = sm.ClusterSpec(n_prefill=4, n_decode=1)
        s2 = sm.Simulator(spec2, sm.make_policy(
            "tetris", LM[side].table1_model(), spec2), trace=True)
        s2.run(wl.make_trace("short", 0.5, 10.0, seed=0))
        sims[side] = s2
    s2 = sims["port"]
    assert s2.tracer.events and s2.tracer.open_spans() == {}
    assert json.dumps(s2.tracer.to_chrome()) == \
        json.dumps(sims["ref"].tracer.to_chrome())
    for r in s2.reqs.values():
        if r.prefill_done is None:
            continue
        comps = s2.tracer.attribution(r.rid, r.arrival, r.prefill_done)
        assert t_tel.attribution_total(comps) == r.ttft


# ---------------------------------------------- real engine, end to end
@pytest.fixture(scope="module")
def P(reduced_params_cache, reference_compile_cache):
    jcfg, jp = reduced_params_cache("yi-9b")
    cfg = get_config("yi-9b").reduced()
    return {"ref": (jcfg, jp),
            "port": (cfg, params_from_numpy(jp, cfg, device="cpu"))}


def _traced(P, side, n_decode, jobs, preempt=(), hook=None, **kw):
    Eng, Req, sim, cp, table1, extra = SIDES[side]
    cfg, params = P[side]
    spec = sim.ClusterSpec(n_prefill=8, n_decode=n_decode,
                           sp_candidates=(1, 2, 4))
    eng = Eng(cfg, params, spec, _mixed_two_chunk(sim, cp)(table1(), spec),
              block_size=16, **kw, **extra)
    for rid, arrival, prompt, out in jobs:
        eng.submit(Req(rid=rid, arrival=arrival, prompt_len=len(prompt),
                       output_len=out), prompt)
    for rid, at in preempt:
        eng.preempt(rid, at=at)
    if hook is not None:
        hook(eng)
    eng.serve()
    return eng


def _run_pair(P, n_decode, jobs, preempt=(), **kw):
    ref = _traced(P, "ref", n_decode, jobs, preempt, **kw)
    port = _traced(P, "port", n_decode, jobs, preempt, **kw)
    got, want = _records(port), _records(ref)
    for key in want:
        assert got[key] == want[key], key
    return {"ref": ref, "port": port}


# tests/test_telemetry.py:268's engine settings
PRESSURE_KW = dict(max_batch=4, max_seq=64, decode_hosts={0: tuple(range(8))},
                   piggyback=True, preempt_watermark=0.3,
                   preempt_policy="swap", prefill_pool_blocks=64)


def _pressure_jobs(P):
    rng = np.random.default_rng(1)
    vocab = P["port"][0].vocab_size
    return [(i, a, rng.integers(0, vocab, 60), 24)
            for i, a in enumerate((0.0, 0.05, 0.1, 0.15))]


@pytest.fixture(scope="module")
def traced_pressure_run(P):
    """tests/test_telemetry.py:268: a colocated piggyback run under block
    pressure with swap preemption — chunks, fused and deferred ticks,
    swap round trips, transfers and finishes — on both engines."""
    return _run_pair(P, 1, _pressure_jobs(P), **PRESSURE_KW)


@pytest.fixture(scope="module")
def traced_fabric_run(P):
    """tests/test_telemetry.py:371: a two-instance run whose swap victim
    resumes on the emptied instance; the calm run that times the
    preemption runs on the port."""
    rng = np.random.default_rng(31)
    vocab = P["port"][0].vocab_size
    prompts = [rng.integers(0, vocab, 64).astype(np.int32)
               for _ in range(3)]
    jobs = [(i, i * 0.005, prompts[i], out)
            for i, out in enumerate((24, 18, 16))]

    def kw(side):
        return dict(max_batch=1, max_seq=128, preempt_policy="swap",
                    offload_model=LM[side].HostOffloadModel(pcie_bw=1e8,
                                                            base=0.0))

    calm = _traced(P, "port", 2, jobs, **kw("port"))
    tt = calm.reqs[0].token_times
    pre = ((0, 0.5 * (tt[5] + tt[6])),)
    ref = _traced(P, "ref", 2, jobs, pre, **kw("ref"))
    port = _traced(P, "port", 2, jobs, pre, **kw("port"))
    got, want = _records(port), _records(ref)
    for key in want:
        assert got[key] == want[key], key
    return {"ref": ref, "port": port}


def _rollups(eng) -> dict:
    """What the rollup and fabric audits read, for comparing the sides."""
    return {"counters": eng.metrics.snapshot()["counters"],
            "gauges": eng.metrics.snapshot()["gauges"],
            "ticks": eng.tracer.tick_token_counts(),
            "attribution": {r.rid: eng.tracer.attribution(
                r.rid, r.arrival, r.prefill_done)
                for r in eng.reqs.values()},
            "tbt": {rid: eng.tracer.tbt_causes(rid) for rid in eng.reqs},
            "mixed_log": eng.mixed_log, "restripe_log": eng.restripe_log,
            "n_events": len(eng.tracer.events)}


@pytest.mark.parametrize("run", ["traced_pressure_run", "traced_fabric_run"])
def test_engine_run_telemetry_matches_reference(run, request):
    """Both traced runs: the port's registry counters and gauges, tick
    counts, per-request attribution and TBT causes, mixed and restripe
    logs and event count are the reference's."""
    r = request.getfixturevalue(run)
    got, want = _rollups(r["port"]), _rollups(r["ref"])
    for key in want:
        assert got[key] == want[key], key


def test_engine_run_attribution_bit_equal(traced_pressure_run):
    eng = traced_pressure_run["port"]
    assert eng.preempt_log
    for r in eng.reqs.values():
        comps = eng.tracer.attribution(r.rid, r.arrival, r.prefill_done)
        assert t_tel.attribution_total(comps) == r.ttft, (r.rid, comps)
        assert comps["chunk_compute"] > 0.0
        assert len(eng.tracer.tbt_causes(r.rid)) == len(r.token_times) - 1


def test_engine_run_tick_conservation(traced_pressure_run):
    eng = traced_pressure_run["port"]
    counts = eng.tracer.tick_token_counts()
    ms = eng.mixed_stats
    assert counts["fused"] == ms["piggyback_tokens"]
    assert counts["standalone"] == ms["standalone_tokens"]
    assert counts["fused"] + counts["standalone"] == sum(
        r.output_len for r in eng.reqs.values())


def test_engine_run_spans_closed_and_well_formed(traced_pressure_run):
    eng = traced_pressure_run["port"]
    assert eng.tracer.open_spans() == {}
    by_track = {}
    for e in eng.tracer.events:
        if e.dur > 0.0 and e.kind in ("chunk", "tick", "transfer", "swap",
                                      "decode_resident"):
            by_track.setdefault((e.track, e.kind), []).append(
                (e.t, e.t + e.dur))
    for (track, kind), spans in by_track.items():
        spans.sort()
        for (a0, b0), (a1, b1) in zip(spans, spans[1:]):
            assert a1 >= b0 - 1e-9, (track, kind, (a0, b0), (a1, b1))


def test_engine_run_backcompat_views(traced_pressure_run):
    eng = traced_pressure_run["port"]
    pkeys = {"t", "rid", "instance", "reason", "policy", "swap_in_ms",
             "recompute_ms", "resume_tokens", "free_blocks", "generated",
             "chunks_discarded"}
    assert eng.preempt_log
    for p in eng.preempt_log:
        assert set(p) == pkeys, p
    assert [p["t"] for p in eng.preempt_log] == sorted(
        p["t"] for p in eng.preempt_log)
    assert eng.mixed_log
    for m in eng.mixed_log:
        assert set(m) == {"t", "rid", "chunk", "instance", "ticks",
                          "tokens", "window"}, m
    assert eng.restripe_log == []
    ss = eng.swap_stats
    assert ss["swap_outs"] > 0 and ss["swap_ins"] > 0
    assert ss["bytes_out"] > 0 and ss["swapped_now"] == 0


def test_engine_run_rollups_equal_sum_of_parts(traced_pressure_run):
    eng = traced_pressure_run["port"]
    ms = eng.mixed_stats
    for key in ("piggyback_ticks", "piggyback_tokens", "standalone_ticks",
                "standalone_tokens", "deferred_ticks"):
        assert ms[key] == sum(getattr(i, key) for i in eng.decodes), key
    assert ms["fused_steps"] == len(eng.mixed_log)
    ss = eng.swap_stats
    assert ss["swap_outs"] == eng.swap.counters["swap_outs"]
    assert ss["bytes_out"] == eng.swap.counters["bytes_out"]
    tm_out = sum(d.transfers.stats["swap_out_bytes"] for d in eng.dstates)
    tm_in = sum(d.transfers.stats["swap_in_bytes"] for d in eng.dstates)
    assert tm_out == ss["bytes_out"] and tm_in == ss["bytes_in"]
    reg = eng.metrics.snapshot()["counters"]
    assert sum(v for k, v in reg.items()
               if k.endswith("pcie_out_bytes")) == tm_out
    assert ss["demotions"] == reg.get("host_cache/demotions", 0)
    assert ss["host_prefix_hits"] == reg.get("host_cache/hits", 0)
    for did, d in enumerate(eng.dstates):
        assert eng.metrics.gauge(f"decode{did}/free_blocks").value \
            == d.blocks.n_free
    assert not any(k.startswith("fabric/") for k in reg)
    assert "fabric" not in ss and "per_instance" not in ss


def test_fabric_counters_equal_engine_logs(traced_fabric_run):
    """tests/test_telemetry.py:413 — the fabric registry counters, the
    ``swap_stats["fabric"]`` rollup, the per-instance breakdown, the
    tracer's ``swap_place`` entries and the interconnect books agree."""
    eng = traced_fabric_run["port"]
    ss = eng.swap_stats
    fab = ss["fabric"]
    reg = eng.metrics.snapshot()["counters"]
    assert fab["swap_in_placed"] >= 1
    for key in ("swap_in_placed", "swap_in_pinned", "leases_out",
                "leases_recalled", "peer_promotions", "interconnect_bytes"):
        assert reg.get(f"fabric/{key}", 0) == fab[key], key
    assert len(eng.tracer.entries("swap_place")) == fab["swap_in_placed"]
    assert fab["swap_in_placed"] + fab["swap_in_pinned"] == ss["swap_ins"]
    pi = ss["per_instance"]
    assert sum(p["swap_ins"] for p in pi.values()) == ss["swap_ins"]
    assert sum(p["swap_outs"] for p in pi.values()) == ss["swap_outs"]
    assert sum(p["swap_in_placed"]
               for p in pi.values()) == fab["swap_in_placed"]
    ic = sum(d.transfers.stats["ic_placed_bytes"]
             + d.transfers.stats["ic_peer_promote_bytes"]
             + d.transfers.stats["ic_lease_bytes"] for d in eng.dstates)
    assert ic == fab["interconnect_bytes"]
    assert eng.metrics.gauge("fabric/leases_active").value \
        == eng.fabric.leased_blocks == 0


def test_engine_run_trace_doc_export(tmp_path, traced_pressure_run):
    """tests/test_telemetry.py:442, and the port's document holds the
    reference's requests and event count."""
    eng = traced_pressure_run["port"]
    path = tmp_path / "trace.json"
    doc = eng.export_trace(str(path))
    ref_doc = traced_pressure_run["ref"].export_trace()
    assert doc["schema"] == "trace/v1"
    with open(path) as f:
        loaded = json.load(f)
    assert len(loaded["traceEvents"]) == len(ref_doc["traceEvents"])
    assert json.loads(json.dumps(ref_doc["requests"])) == loaded["requests"]
    xi = [e for e in loaded["traceEvents"] if e["ph"] in ("X", "i")]
    assert len(xi) == len(eng.tracer.events)
    for rid, r in eng.reqs.items():
        rec = loaded["requests"][str(rid)]
        assert t_tel.attribution_total(rec["attribution"]) == r.ttft, rid
        assert len(rec["tbt_causes"]) == len(r.token_times) - 1
    causes = [c for rec in loaded["requests"].values()
              for c in rec["tbt_causes"]]
    assert "fused" in causes or "deferral" in causes or "swap" in causes


# ------------------------------------------- the host phases of a handler
@pytest.fixture(scope="module")
def profiled_pressure_run(P):
    """The pressure run on the port alone with ``profile_ops=True``, the
    wall clock read around every chunk and tick handler (fused ticks,
    which run inside a chunk's handler, included)."""
    walls = {"tick": [], "chunk": []}

    def hook(eng):
        for family, kind in (("tick", "decode_tick"),
                             ("chunk", "chunk_start")):
            fn = getattr(eng, f"_on_{kind}")

            def timed(t, payload, _fn=fn, _out=walls[family]):
                t0 = time.perf_counter()
                _fn(t, payload)
                _out.append((t0, time.perf_counter()))
            setattr(eng, f"_on_{kind}", timed)

    eng = _traced(P, "port", 1, _pressure_jobs(P), hook=hook,
                  profile_ops=True, **PRESSURE_KW)
    return {"eng": eng, "walls": walls}


def test_profiling_changes_no_record(traced_pressure_run,
                                     profiled_pressure_run):
    """The profiled run's tokens, logs, tracer events, counters, gauges
    and other histograms are the unprofiled port run's."""
    eng, plain = profiled_pressure_run["eng"], traced_pressure_run["port"]
    got, want = _records(eng), _records(plain)
    for key in want:
        assert got[key] == want[key], key
    assert json.dumps(eng.tracer.to_chrome()) == \
        json.dumps(plain.tracer.to_chrome())
    snap, base = eng.metrics.snapshot(), plain.metrics.snapshot()
    assert snap["counters"] == base["counters"]
    assert snap["gauges"] == base["gauges"]
    assert {k: v for k, v in snap["histograms"].items()
            if not k.startswith(("host_us/", "op_wall_us/"))} \
        == base["histograms"]


def test_phase_counts_are_the_handlers_that_ran(profiled_pressure_run):
    """One sample a phase for every tick with live rows, fused and
    standalone, and for every chunk that ran; each phase at least 0."""
    eng = profiled_pressure_run["eng"]
    ms = eng.mixed_stats
    assert ms["piggyback_ticks"] > 0 and ms["standalone_ticks"] > 0
    n_chunks = sum(len(v) for v in eng.chunk_log.values())
    for family, n in (("tick", ms["piggyback_ticks"]
                       + ms["standalone_ticks"]), ("chunk", n_chunks)):
        for p in t_tel.PHASES:
            h = eng.metrics.hists[f"host_us/{family}.{p}"]
            assert h.count == n, (family, p)
            assert h.vmin >= 0.0, (family, p)
    assert eng.metrics.hists["host_us/tick.wait"].vmax > 0.0
    # the first token's readback runs on every request's last chunk
    assert eng.metrics.hists["host_us/chunk.wait"].vmax > 0.0


def test_phases_partition_within_each_handler(profiled_pressure_run):
    """Every kept span lies inside a handler of its family, and a
    handler's phases sum to no more than the wall clock around it; every
    handler that recorded phases recorded all four."""
    eng, walls = profiled_pressure_run["eng"], profiled_pressure_run["walls"]
    spans = list(eng.profiler.spans)
    for family, windows in walls.items():
        mine = [s for s in spans if s[0].startswith(family + ".")]
        seen = 0
        for w0, w1 in windows:
            inside = [s for s in mine if w0 <= s[1] <= s[2] <= w1]
            if not inside:
                continue
            seen += len(inside)
            assert {s[0] for s in inside} == {
                f"{family}.{p}" for p in t_tel.PHASES}
            assert sum(t1 - t0 for _, t0, t1 in inside) <= w1 - w0
        assert seen == len(mine), family


def test_profiling_off_keeps_no_phase(traced_pressure_run):
    eng = traced_pressure_run["port"]
    assert not any(k.startswith("host_us/") for k in eng.metrics.hists)
    assert not eng.profiler.spans
    assert "hostEvents" not in eng.export_trace()


def test_host_spans_export_apart_from_trace_events(traced_pressure_run,
                                                   profiled_pressure_run):
    """``to_chrome`` gives one ``X`` event a kept span on the ``host``
    process, a track a family; the trace document carries them under
    ``hostEvents`` and its ``traceEvents`` are the unprofiled run's."""
    eng = profiled_pressure_run["eng"]
    host = eng.profiler.to_chrome()
    xs = [e for e in host if e["ph"] == "X"]
    assert len(xs) == len(eng.profiler.spans)
    assert all(e["dur"] >= 0.0 and e["cat"] == "host" for e in xs)
    tracks = {e["args"]["name"]: e["tid"] for e in host
              if e["name"] == "thread_name"}
    assert set(tracks) == {"tick", "chunk"}
    assert all(e["tid"] == tracks[e["name"].split(".")[0]] for e in xs)
    doc = eng.export_trace()
    assert doc["hostEvents"] == host
    assert doc["traceEvents"] == traced_pressure_run["port"].export_trace()[
        "traceEvents"]
