"""encoder_device_ms.train: the encoder's (networks/: the backbone, light estimator and hand heads)
device ms a train step, from the spans encoder and encoder.bwd with their descendants."""

from benchmark.measures import span_device_ms

SPANS = ("encoder", "encoder.bwd")


def read(run):
    return span_device_ms(run, SPANS)
