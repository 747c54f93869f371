"""mfu.decode: the useful operations of the decode ticks' live rows
(``yardstick.StepWork.row_flops`` at each row's cache length) over the
ticks' summed host time at the card's bf16 peak, in percent."""

from yardstick import PEAK_FLOPS


def read(run):
    flops = secs = 0.0
    for a, b, n, lens in run.stamps.ticks:
        if n:
            flops += sum(run.work.row_flops(x) for x in lens)
            secs += b - a
    return 100.0 * flops / (secs * PEAK_FLOPS) if secs > 0 else None
