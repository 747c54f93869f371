"""CPU tests of the benchmark (``python -m pytest -q cardbench``): a cell
end to end on a reduced Yi-9B and Mamba-2 through the port's plain path,
the traffic generator, the pump's stamps, the plain references against
the port, the control and planted faults against ``correct``, and the
rule that nothing of JAX or the JAX package is loaded."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import check
import run
import traffic as tf
from faults import FAULTS

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = run.load_json(ROOT, "BENCHMARK.json")
CELLS = {"yi": "yi9b-doc6k", "mamba": "mamba2-doc16k"}


def tiny(kind: str) -> tuple:
    """The cell's configuration at a CPU test's size (widths cut, the
    architecture kept) and its traffic with short prompts."""
    _, c, t, _, _ = run.cell_files(BENCH, CELLS[kind])
    c, t = copy.deepcopy(c), copy.deepcopy(t)
    if kind == "yi":
        c.update(hidden_size=64, intermediate_size=128,
                 num_attention_heads=4, num_key_value_heads=2,
                 num_hidden_layers=2, vocab_size=512)
    else:
        c.update(d_model=64, n_layer=2, d_state=16, headdim=16,
                 chunk_size=32, vocab_size=512)
    t.update(prompt={"min": 64, "max": 1024, "mean": 300, "sigma": 0.7},
             output={"min": 4, "max": 16, "mean": 8, "sigma": 0.6},
             warmup=[[128, 2]], rate_per_s=4.0, drain_cap_s=20)
    t["engine"].update(max_seq=1024, prefill_pool_tokens=8192)
    t["check"]["tokens"] = 40
    return c, t


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(kind, **kw):
    c, t = tiny(kind)
    return run.run_cell(c, t, seed=2 ** 31 + 11, seconds=2.0,
                        device="cpu", **kw)


# ------------------------------------------------------------- end to end
@pytest.mark.parametrize("kind", ["yi", "mamba"])
def test_cell_end_to_end_prints_a_well_formed_line(kind):
    e2e = run.cell_files(BENCH, CELLS[kind])[4]
    res = _cell(kind, trace=False, end_to_end_metrics=e2e)
    out = json.loads(json.dumps(res["result"]))
    assert list(out)[-1] == "check"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in out
    assert out["correct"] is True and out["failed"] == 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if CELLS[kind] in m.get("workloads", [CELLS[kind]])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["check"]["widest_gap"]["value"] <= 1e-3


@pytest.mark.parametrize("kind", ["yi", "mamba"])
def test_traced_run_reads_the_host_side_layers(kind):
    cell = CELLS[kind]
    per = [(m["name"], m["unit"]) for m in BENCH["per_layer"]
           if cell in m.get("workloads", [cell])]
    res = _cell(kind, trace=True, per_layer=per)
    got = res["result"]["metrics"]
    # the device trace and the op profiler's device times exist only on
    # the card; every reader of the host's stamps finds its numbers
    assert {"engine.queue_wait_p50_s", "engine.decode_rows",
            "sched.chunks_per_req", "sched.plan_ms", "step.tick_ms",
            "mfu.decode"} <= set(got)
    # the TBT tail is per-layer where it is too unsteady end to end
    assert ("engine.tbt_p95_ms" in got) == (kind == "mamba")
    if kind == "mamba":
        assert got["engine.tbt_p95_ms"]["value"] > 0
    assert not any(n.endswith("_roofline") or n == "device.idle_share"
                   for n in got)
    assert 0 < got["mfu.decode"]["value"] < 100


def test_run_refuses_without_a_card(tmp_path):
    """No card here: exit 2 and no result, also from a directory that
    holds only BENCHMARK.json and the benchmark's files."""
    import shutil
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), alone)
    shutil.copytree(HERE, alone / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, str(alone)):
        p = subprocess.run(
            [sys.executable, "cardbench/run.py", "--workload", "yi9b-doc6k",
             "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == ""


# ---------------------------------------------------------------- traffic
def test_traffic_is_the_same_work_for_every_seed():
    _, t = tiny("yi")
    a = tf.make_jobs(t, 2 ** 31 + 7, 10.0, 512)
    b = tf.make_jobs(t, 2 ** 31 + 7, 10.0, 512)
    d = tf.make_jobs(t, 5, 10.0, 512)
    assert [(j.due, j.output_len, j.prompt.tolist()) for j in a] == \
        [(j.due, j.output_len, j.prompt.tolist()) for j in b]
    assert [(j.due, j.output_len, j.prompt_len) for j in a] == \
        [(j.due, j.output_len, j.prompt_len) for j in d]
    assert [j.prompt.tolist() for j in a] != [j.prompt.tolist() for j in d]
    # the file's order is a permutation, not the sorted quantiles
    assert [j.prompt_len for j in a] != sorted(j.prompt_len for j in a)
    assert len(a) == round(t["rate_per_s"] * 10.0)
    due = [j.due for j in a]
    assert due == sorted(due) and 0 < due[0] and due[-1] < 10.0


def test_lengths_keep_their_bounds_and_mean():
    spec = {"min": 1024, "max": 16384, "mean": 6000, "sigma": 0.7}
    x = tf.lengths(spec, 4000)
    assert x.min() >= 1024 and x.max() <= 16384
    assert abs(x.mean() - 6000) < 60


# ------------------------------------------------------------------ pump
def test_pump_stamps_each_token_once_and_nothing_before_its_due():
    import pump
    from repro_torch.models.sharding import make_context
    c, t = tiny("yi")
    fam = run.family("llama")
    cfg = fam.port_config(c, dtype="float32")
    eng = pump.build_engine(cfg, fam.make_weights(c, 3, "cpu",
                                                  torch.float32),
                            make_context("cpu"), t["engine"], False)
    p = pump.Pump(eng)
    jobs = tf.make_jobs(t, 3, 2.0, c["vocab_size"])
    end = p.run(jobs, 2.0, 20.0)
    st = p.st
    assert set(st.due) == set(range(len(jobs)))
    for rid, due in st.due.items():
        assert st.submitted[rid] >= due
        assert st.first_chunk[rid] >= st.submitted[rid]
        toks = st.tokens[rid]
        assert len(toks) == len(eng.outputs[rid]) == jobs[rid].output_len + 1
        assert toks == sorted(toks) and toks[0] >= st.first_chunk[rid]
        assert toks[-1] <= end
    assert sum(n for _, _, n, _ in st.ticks) == sum(
        len(eng.outputs[r]) - 1 for r in st.due)
    assert len(st.tick_cpu) == len(st.ticks)


def test_knee_rule_reads_a_growing_queue_and_a_steady_one():
    """The knee sweep's rule: a backlog that holds through the window is
    sustained, one that grows with the time is not, and a request left
    unfinished fails the rate whatever the backlog."""
    import knee
    due = np.arange(0.0, 40.0, 0.5)
    steady = {"due": due, "e2e": np.full(len(due), 3.0),
              "ttft": np.full(len(due), 0.3),
              "result": {"failed": 0}}
    r = knee.reading(steady, 40.0)
    assert r["sustained"] and abs(r["growth"] - 1.0) < 0.05
    growing = dict(steady, e2e=0.5 * due + 1.0)    # service falls behind
    r = knee.reading(growing, 40.0)
    assert not r["sustained"] and r["growth"] > 1.5
    assert r["e2e_slope"] == pytest.approx(0.5)
    assert not knee.reading(dict(steady, result={"failed": 1}),
                            40.0)["sustained"]


def test_knee_writes_the_rate_and_the_sweep_into_the_traffic_file(
        tmp_path):
    """The knee is the highest rate below which every run on every seed
    held (a rate held above a failed one does not count); the traffic
    file gets 0.8 x the knee and the readings, and reads back whole."""
    import knee
    _, t = tiny("yi")
    row = {k: 1.0 for k in knee.KEPT}
    rows = [dict(row, rate_per_s=r, seed=s, sustained=ok)
            for r, s, ok in [(1.0, 1, True), (1.0, 2, True), (2.0, 1, True),
                             (2.0, 2, False), (3.0, 1, True),
                             (3.0, 2, True)]]
    assert knee.knee_of(rows) == 1.0
    assert knee.knee_of(rows[2:4]) is None
    path = tmp_path / "t.json"
    knee.write_traffic(str(path), t, rows, 1.0, 50)
    back = json.loads(path.read_text())
    assert back["rate_per_s"] == 0.8 and len(back["knee"]["sweep"]) == 6
    assert {k: v for k, v in back.items() if k not in ("rate_per_s",
            "knee")} == {k: v for k, v in t.items()
                         if k not in ("rate_per_s", "knee")}


# ------------------------------------------------------------ references
def _port_logits(cfg, weights, toks):
    from repro_torch.models.sharding import make_context
    from repro_torch.models.transformer import forward
    x = torch.as_tensor(toks)[None]
    pos = torch.arange(len(toks), dtype=torch.int32)[None]
    lg, _, _ = forward(weights, cfg, make_context("cpu"), x, pos, "train")
    return lg[0, :, :cfg.vocab_size]


@pytest.mark.parametrize("kind", ["yi", "mamba"])
def test_reference_agrees_with_the_port_on_a_tiny_model(kind):
    c, _ = tiny(kind)
    if kind == "mamba":
        c["chunk_size"] = 16                 # several chunks of the scan
    fam = run.family(c["family"])
    w = fam.make_weights(c, 9, "cpu", torch.float32)
    from repro_torch.models.params import param_shapes
    cfg = fam.port_config(c, dtype="float32")
    flat = lambda tr: {k: (flat(v) if isinstance(v, dict) else tuple(v))
                       for k, v in tr.items()}
    assert flat(fam.layout(c)) == flat(param_shapes(cfg))
    toks = np.random.default_rng(0).integers(0, c["vocab_size"], 100)
    want = _port_logits(cfg, w, toks)
    got = check.load_ref(fam.REF).logits(w, c, [toks], [np.arange(100)])[0]
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), \
        (got - want).abs().max()


def test_chunked_ssd_matches_the_recurrence():
    ref = check.load_ref("mamba2")
    g = torch.Generator().manual_seed(0)
    S, H, P, G, N = 70, 4, 8, 2, 5
    x = torch.randn(S, H, P, generator=g)
    dt = torch.rand(S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 2
    B = torch.randn(S, G, N, generator=g)
    C = torch.randn(S, G, N, generator=g)
    y = ref.ssd(x, dt, A, B, C, chunk=16, block=2)
    h = torch.zeros(H, P, N)
    want = []
    for t in range(S):
        Bt = B[t].repeat_interleave(H // G, 0)
        Ct = C[t].repeat_interleave(H // G, 0)
        h = h * torch.exp(dt[t] * A)[:, None, None] + \
            (dt[t][:, None] * x[t])[..., None] * Bt[:, None]
        want.append(torch.einsum("hn,hpn->hp", Ct, h))
    assert torch.allclose(y, torch.stack(want), atol=1e-4)


# ------------------------------------------------------ control and faults
@pytest.mark.parametrize("kind", ["yi", "mamba"])
def test_control_reads_wider_than_the_program(kind):
    """The control (the reference in float8) against the program serving
    in bfloat16, as on the card, at a width the CPU holds: the control's
    widest gap is over three times the program's, and the control's
    tokens go through the same decision as the program's, at the same
    limit and token count.  (At this width and depth the control reads
    under the card's limit; the card readings in PERF.md set the
    limit.)"""
    c, t = tiny(kind)
    c.update({"hidden_size": 128, "intermediate_size": 256,
              "vocab_size": 4096} if kind == "yi" else
             {"d_model": 128, "vocab_size": 4096})
    t["output"] = {"min": 8, "max": 32, "mean": 16, "sigma": 0.6}
    t["check"]["tokens"] = 200
    res = run.run_cell(c, t, seed=2, seconds=3.0, trace=False, device="cpu",
                       control=True, dtype="bfloat16")
    program = res["check"][0][1]
    control = res["control"]["check"][0][1]
    assert res["check"][1][1] >= 200
    assert 0 < program and control > 3 * program
    assert res["control"]["check"][1:] == res["check"][1:]
    assert res["control"]["correct"] == (control <= t["check"]["max_gap"])
    mid = dict(t["check"], max_gap=(program * control) ** 0.5)
    assert run.decide(program, 200, mid)[0] and \
        not run.decide(control, 200, mid)[0]


@pytest.mark.parametrize("kind", ["yi", "mamba"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_planted_fault_is_not_correct(kind, fault):
    import repro_torch.serving.engine as E
    fwd = E.forward
    res = _cell(kind, trace=False, fault=FAULTS[fault])
    assert E.forward is fwd            # what the fault patched is undone
    assert res["result"]["correct"] is False


def test_no_jax_and_no_program_in_the_reference():
    code = (
        "import sys, json, numpy as np, torch\n"
        f"sys.path[:0] = [{HERE!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "import test_cardbench as T, run, check\n"
        "torch.set_num_threads(2)\n"
        "c, t = T.tiny('yi')\n"
        "fam = run.family('llama')\n"
        "w = fam.make_weights(c, 1, 'cpu', torch.float32)\n"
        "check.load_ref('llama').logits(w, c, [np.arange(50)], [[49]])\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'repro', 'repro_torch'))\n"
        "run.run_cell(c, t, 5, 1.0, False, device='cpu')\n"
        "print(json.dumps([ref, run.forbidden_modules()]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    ref, bad = json.loads(p.stdout.strip().splitlines()[-1])
    assert ref == [] and bad == []
