"""mfu.prefill: the useful operations of the run's prefill chunks
(``yardstick.StepWork.chunk_flops``) over their summed device time (the
op profiler's ``op_device_us/prefill_chunk``) at the card's bf16 peak,
in percent."""

from yardstick import PEAK_FLOPS


def read(run):
    n, us = run.ops.get("op_device_us/prefill_chunk", (0, 0.0))
    if not n or us <= 0:
        return None
    flops = sum(run.work.chunk_flops(off, L)
                for _, off, L, _ in run.stamps.chunks)
    return 100.0 * flops / (us * 1e-6 * PEAK_FLOPS)
