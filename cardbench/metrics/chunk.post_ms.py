"""chunk.post_ms: the mean host milliseconds, over every prefill chunk that
ran, of a prefill chunk's host work after its launches and around its
readback: the chunk log, the controller and the colocated instance's
step window.  The engine's phase span ``host_us/chunk.post`` on
``time.perf_counter`` (``profile_ops``, the traced run); nothing to read
where the program has no such span."""


def read(run):
    return run.op_ms("host_us/chunk.post")
