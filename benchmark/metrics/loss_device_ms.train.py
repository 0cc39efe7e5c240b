"""loss_device_ms.train: the loss stack's (losses/: SSIM and the VGG19 inside) device ms a train step,
from the spans loss and loss.bwd with their descendants."""

from benchmark.measures import span_device_ms

SPANS = ("loss", "loss.bwd")


def read(run):
    return span_device_ms(run, SPANS)
