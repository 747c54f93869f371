"""tick.graph_share: the share of the decode ticks with live rows, in
the window and its drain, that replayed a captured CUDA graph rather
than launching the forward op by op, in %.  The engine's histogram
``tick_graph/replayed`` (1 for a replayed tick, 0 for an eager one);
nothing to read where the program has no such histogram."""


def read(run):
    n, total = run.ops.get("tick_graph/replayed", (0, 0.0))
    return 100.0 * total / n if n else None
