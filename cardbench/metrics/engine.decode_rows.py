"""engine.decode_rows: the mean number of tokens a decode tick that
produced any added to the engine's outputs (rows of the batch at work),
over the ticks of the window and its drain."""


def read(run):
    rows = [t[2] for t in run.stamps.ticks if t[2]]
    return sum(rows) / len(rows) if rows else None
