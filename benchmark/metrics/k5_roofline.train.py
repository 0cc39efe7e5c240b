"""k5_roofline.train: K5's (SSIM's) least time per call over its device time per call."""

from benchmark.measures import kernel_roofline


def read(run):
    return kernel_roofline(run, "K5")
