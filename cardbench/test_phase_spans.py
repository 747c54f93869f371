"""CPU tests of the phase metrics (``python -m pytest -q cardbench``): in a
traced run of each tiny cell the eight readers of the engine's host
phase spans (``cardbench/metrics/tick.*_ms.py``, ``chunk.*_ms.py``) find
their numbers, and the phases of a tick add up to no more than the
pump's wall clock around the handler (``step.tick_ms``)."""

import pytest
import torch

import run
from test_cardbench import BENCH, CELLS, tiny

PHASES = ("prep", "launch", "wait", "post")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["yi", "mamba"])
def test_traced_run_reads_the_phase_spans(kind):
    cell = CELLS[kind]
    per = [(m["name"], m["unit"]) for m in BENCH["per_layer"]
           if cell in m.get("workloads", [cell])]
    names = {f"{f}.{p}_ms" for f in ("tick", "chunk") for p in PHASES}
    assert names <= {n for n, _ in per}
    c, t = tiny(kind)
    res = run.run_cell(c, t, seed=2 ** 31 + 13, seconds=2.0, device="cpu",
                       trace=True, per_layer=per)
    got = {k: v["value"] for k, v in res["result"]["metrics"].items()}
    assert names <= set(got)
    assert all(got[n] >= 0.0 for n in names)
    assert sum(got[f"tick.{p}_ms"] for p in PHASES) <= got["step.tick_ms"]
