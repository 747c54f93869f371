"""chunk.wait_ms: the mean host milliseconds, over every prefill chunk that
ran, of a prefill chunk's wait for the card: the first token's readback
on a prompt's last chunk, zero on its other chunks.  The engine's phase
span ``host_us/chunk.wait`` on ``time.perf_counter`` (``profile_ops``,
the traced run); nothing to read where the program has no such span."""


def read(run):
    return run.op_ms("host_us/chunk.wait")
