"""chunk.launch_ms: the mean host milliseconds, over every prefill chunk
that ran, of a prefill chunk's launches: ``prefill_chunk_paged`` and the
KV scatter into the pages (``write_chunk``).  The engine's phase span
``host_us/chunk.launch`` on ``time.perf_counter`` (``profile_ops``, the
traced run); nothing to read where the program has no such span."""


def read(run):
    return run.op_ms("host_us/chunk.launch")
