"""k4_roofline.train: K4's (the SSAA face selection's) least time per call over its device time per call."""

from benchmark.measures import kernel_roofline


def read(run):
    return kernel_roofline(run, "K4")
