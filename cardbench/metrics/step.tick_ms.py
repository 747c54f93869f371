"""step.tick_ms: the mean host milliseconds of a decode tick that
produced tokens (the pump's clock around ``_on_decode_tick``, which ends
in the tokens' copy to the host)."""


def read(run):
    ms = [(b - a) * 1e3 for a, b, n, _ in run.stamps.ticks if n]
    return sum(ms) / len(ms) if ms else None
