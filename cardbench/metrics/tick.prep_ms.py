"""tick.prep_ms: the mean host milliseconds, over every decode tick with
live rows, of a decode tick's host work before the forward: rows grown
or preempted, the token and length arrays copied to the card, the block
table and the per-row caches.  The engine's phase span
``host_us/tick.prep`` on ``time.perf_counter`` (``profile_ops``, the
traced run); nothing to read where the program has no such span."""


def read(run):
    return run.op_ms("host_us/tick.prep")
