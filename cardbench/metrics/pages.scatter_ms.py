"""pages.scatter_ms: the mean device milliseconds of a chunk's KV
scatter into the prefill pages, from the engine's op profiler
(``op_device_us/scatter_chunk``).  Nothing to read where the model has
no attention layer."""


def read(run):
    if run.c["family"] != "llama":
        return None
    return run.op_ms("op_device_us/scatter_chunk")
