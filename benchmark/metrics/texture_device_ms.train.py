"""texture_device_ms.train: the per-fragment UV texture sampling's (render/texture.py `sample_texture`:
K2's fetch of texel quads, K3 in backward) device ms a train step, from the spans renderer.texture (in
the shade pass and in its recompute) and renderer.texture.bwd with their descendants."""

from benchmark.measures import span_device_ms

SPANS = ("renderer.texture", "renderer.texture.bwd")


def read(run):
    return span_device_ms(run, SPANS)
