"""ssaa_shade_device_ms.train: the SSAA shade pass's (render/renderer.py `_forward_ssaa`'s `shade`, the
texture sampling inside) device ms a train step, from the spans renderer.shade and renderer.shade.bwd with
their descendants. Checkpoint's recompute of the pass, renderer.shade.recompute, runs inside
renderer.shade.bwd on the autograd thread, so it is counted there, once."""

from benchmark.measures import span_device_ms

SPANS = ("renderer.shade", "renderer.shade.bwd")


def read(run):
    return span_device_ms(run, SPANS)
