"""sched.plan_ms: the mean host milliseconds of an ``arrive`` event, in
which the Tetris policy plans the request's chunks (the pump's clock
around each event)."""


def read(run):
    ms = [(b - a) * 1e3 for kind, a, b in run.stamps.events
          if kind == "arrive"]
    return sum(ms) / len(ms) if ms else None
