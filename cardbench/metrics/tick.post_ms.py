"""tick.post_ms: the mean host milliseconds, over every decode tick with
live rows, of a decode tick's host work after its readback: outputs,
hash publishing, the modelled clock's bookkeeping and evictions.  The
engine's phase span ``host_us/tick.post`` on ``time.perf_counter``
(``profile_ops``, the traced run); nothing to read where the program has
no such span."""


def read(run):
    return run.op_ms("host_us/tick.post")
