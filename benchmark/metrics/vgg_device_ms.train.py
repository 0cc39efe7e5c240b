"""vgg_device_ms.train: the perceptual loss's VGG19 (losses/perceptual.py) device ms a train step, from
the spans loss.perceptual and loss.perceptual.bwd with their descendants."""

from benchmark.measures import span_device_ms

SPANS = ("loss.perceptual", "loss.perceptual.bwd")


def read(run):
    return span_device_ms(run, SPANS)
