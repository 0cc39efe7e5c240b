"""k1_roofline.train: K1's least time per call over its device time per call."""

from benchmark.measures import kernel_roofline


def read(run):
    return kernel_roofline(run, "K1")
