"""CPU test of the reader of ``tick.graph_share``
(``python -m pytest -q cardbench``): nothing without the engine's
histogram, and the share of replayed ticks where it has one."""

import os

import pytest

import run

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("ops, share", [
    ({}, None), ({"tick_graph/replayed": (0, 0.0)}, None),
    ({"tick_graph/replayed": (40, 40.0)}, 100.0),
    ({"tick_graph/replayed": (40, 30.0)}, 75.0),
    ({"tick_graph/replayed": (40, 0.0)}, 0.0)])
def test_graph_share_reads_the_replayed_ticks(ops, share):
    mod = run.load_module(os.path.join(HERE, "metrics",
                                       "tick.graph_share.py"),
                          "cardbench_metric_tick_graph_share")
    got = mod.read(run.Run(c={}, traffic={}, stamps=None, work=None,
                           end_s=0.0, ops=ops))
    assert got == share
