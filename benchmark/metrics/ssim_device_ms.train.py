"""ssim_device_ms.train: the SSIM terms' (losses/ssim.py, K5) device ms a train step, from the spans
loss.ssim and loss.ssim.bwd with their descendants."""

from benchmark.measures import span_device_ms

SPANS = ("loss.ssim", "loss.ssim.bwd")


def read(run):
    return span_device_ms(run, SPANS)
