"""k3_roofline: K3's share of its roofline in the traced sub-window,
in percent: the least time of its calls (each call's useful operations
at the bf16 peak or its bytes at the HBM bandwidth, whichever is larger;
``yardstick.k3_work``) over the kernel time the device trace gives its
kernels.  Nothing to read where no call ran in the sub-window."""

from roofline import share


def read(run):
    return share(run, "K3")
