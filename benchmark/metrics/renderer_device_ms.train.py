"""renderer_device_ms.train: the renderer's (render/: K1-K3 inside) device ms a train step, from the
spans renderer and renderer.bwd with their descendants."""

from benchmark.measures import span_device_ms

SPANS = ("renderer", "renderer.bwd")


def read(run):
    return span_device_ms(run, SPANS)
