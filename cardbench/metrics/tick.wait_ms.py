"""tick.wait_ms: the mean host milliseconds, over every decode tick with
live rows, of a decode tick's wait for the card: the next tokens' copy
to the host.  The engine's phase span ``host_us/tick.wait`` on
``time.perf_counter`` (``profile_ops``, the traced run); nothing to read
where the program has no such span."""


def read(run):
    return run.op_ms("host_us/tick.wait")
