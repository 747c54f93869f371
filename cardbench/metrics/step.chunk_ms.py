"""step.chunk_ms: the mean device milliseconds of a prefill chunk's
forward, from the engine's op profiler (CUDA events around
``prefill_chunk_paged``: ``op_device_us/prefill_chunk``)."""


def read(run):
    return run.op_ms("op_device_us/prefill_chunk")
