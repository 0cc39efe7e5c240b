"""The benchmark's plain fp32 reference for a configuration that renders by
supersampling (`aa_mode: "ssaa"`): `benchmark.reference` with the SSAA
render added, which that package refuses. It imports nothing of
`hifihr_tpu_torch` (nor JAX); the unchanged parts (configuration, encoder,
hand layers, loss stack, train step, Adam) are `benchmark.reference`'s own.

What it adds is a frozen plain copy of the port's SSAA path
(render/renderer.py `_forward_ssaa`, render/raster.py's K4 contract):
  raster.py    the face selection at every pixel centre of the supersampled
               image, "the nearest inside face, ties to the lower id",
               from the (pixel, face) pairs of each face's box, per block
               of images
  renderer.py  the shade pass: barycentrics, the vertex channels
               [tangents | normals | points] and the atlas corners
               interpolated, the UV maps sampled per fragment, Phong, the
               aa_factor x aa_factor average pool, recomputed in backward
               under `torch.utils.checkpoint` as the port does
  models.py    the reference's model with that renderer

Where it departs from the port's maths:
  - the face selection evaluates each (pixel, face) pair whose face box,
    widened by a pixel, holds the pixel centre, and keeps per pixel the
    least (depth bits, face id) key: the port's rule bit for bit (K4 and
    its plain version evaluate every face a tile or a chunk's window
    lists, with the same float32 arithmetic in the same order);
  - the per-fragment fetches are `torch.gather` (K2 copies the same
    rows) and their backward autograd's scatter-add (K3 adds the same
    values in another order, so the last bits of a sum differ);
  - SSIM is benchmark.reference's grouped convolution, not K5.

The check takes this package by the six names of
benchmark/spec.py's REFERENCE_ENTRY_POINTS.
"""

from __future__ import annotations

from benchmark.reference import Config, LossComputer, create_train_state, make_sched, make_train_step
from benchmark.reference_ssaa.models import build_model

__all__ = ["Config", "LossComputer", "build_model", "create_train_state", "make_sched", "make_train_step"]
