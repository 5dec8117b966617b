"""skinning_roofline: the skinning kernel's least time on the card over
its device time, over the traced steady span (gpubench/kernels/skinning.py
counts the work)."""
from gpubench.roofline import kernel_roofline


def read(run):
    return kernel_roofline(run, "skinning")
