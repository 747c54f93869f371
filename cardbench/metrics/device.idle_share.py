"""device.idle_share: the share of the traced sub-window in which no
kernel ran on the card (1 - the union of the kernel intervals of the
device trace / the sub-window), in percent."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
