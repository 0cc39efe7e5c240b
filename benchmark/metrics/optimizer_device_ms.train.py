"""optimizer_device_ms.train: the optimizer's (training/train_state.py: zero_grad, the skip guard,
Adam) device ms a train step, from the spans optimizer (twice a step) with their descendants."""

from benchmark.measures import span_device_ms

SPANS = ("optimizer",)


def read(run):
    return span_device_ms(run, SPANS)
