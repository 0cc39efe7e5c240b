"""hand_device_ms.train: the hand layer's (hand/mano.py or hand/nimble.py) device ms a train step, from
the spans hand and hand.bwd with their descendants."""

from benchmark.measures import span_device_ms

SPANS = ("hand", "hand.bwd")


def read(run):
    return span_device_ms(run, SPANS)
