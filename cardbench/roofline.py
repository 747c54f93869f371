"""A kernel group's share of its roofline in the traced sub-window."""


def share(run, group: str):
    """100 x the summed least time of the group's calls
    (``run.kernel_least``) / the group's kernel seconds in the device
    trace; None where the sub-window holds none of either."""
    t, least = run.trace, run.kernel_least
    if t is None or not least or not least.get(group):
        return None
    secs = t["group_s"].get(group, 0.0)
    return 100.0 * least[group] / secs if secs > 0 else None
