"""chunk.prep_ms: the mean host milliseconds, over every prefill chunk that
ran, of a prefill chunk's host work before its forward: the prefill pool
extended, a host prefix promoted, the token and position tensors.  The
engine's phase span ``host_us/chunk.prep`` on ``time.perf_counter``
(``profile_ops``, the traced run); nothing to read where the program has
no such span."""


def read(run):
    return run.op_ms("host_us/chunk.prep")
