"""tick.launch_ms: the mean host milliseconds, over every decode tick with
live rows, of a decode tick's launches: the forward, the rows' new state
absorbed and the argmax.  The engine's phase span
``host_us/tick.launch`` on ``time.perf_counter`` (``profile_ops``, the
traced run); nothing to read where the program has no such span."""


def read(run):
    return run.op_ms("host_us/tick.launch")
