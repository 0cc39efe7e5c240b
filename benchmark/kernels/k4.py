"""K4, the SSAA face selection (hifihr_tpu_torch/render/raster.py,
csrc/raster_face.cu): one route a call, a zero fill of the per-bin face
bitmasks (a memset) right before `face_bin_kernel`, then `face_fine_kernel`.

A call is seen at the renderer's `select_faces_ssaa`, which keeps its scene
(the posed mesh and the base image's camera) by reference. Its least time is
K4's work on that scene, worked out again by the reference's projection at
aa_factor x the intrinsics, the larger of
- bytes: the projected faces read once (B F 9 floats) and the face ids
  written once (B S^2 int32; the renderer reads no depth);
- operations: OPS_PER_PAIR for each (pixel, face) pair whose face box
  touches the pixel (roofline.box_pairs over the faces with every vertex at
  z > 1e-6): the work the selection needs for these inputs, however it
  culls."""

import torch

from benchmark import roofline

WRAPS = ("hifihr_tpu_torch.render.renderer", "PhongRenderer.select_faces_ssaa")
TRACE = (("face_bin_kernel", ("Memset",)), ("face_fine_kernel", ()))
# csrc/raster_face.cu's inner loop: 15 for the edges, 2 area adds, the
# |area| test, 3 divisions, 3 sign tests, 5 for the depth, 1 depth test
OPS_PER_PAIR = 30


def record(renderer, verts_cam, K):
    """What a call keeps: references to its scene, nothing copied."""
    s = renderer.settings
    return verts_cam.detach(), K, renderer.faces, s.image_size, s.aa_factor


def bound_s(call) -> float:
    from benchmark.reference.render.raster import project_to_screen
    from benchmark.reference_ssaa.raster import face_triangles
    from benchmark.reference_ssaa.renderer import scale_intrinsics

    verts, K, faces, size, aa = call
    tri = face_triangles(project_to_screen(verts, scale_intrinsics(K, float(aa))), faces)
    B, F, _ = tri.shape
    S = size * aa
    valid = torch.minimum(torch.minimum(tri[..., 2], tri[..., 5]), tri[..., 8]) > 1e-6
    u, v = tri[..., 0::3], tri[..., 1::3]
    inf = torch.full((), float("inf"), device=tri.device)
    bbox = torch.stack([u.amin(-1), u.amax(-1), v.amin(-1), v.amax(-1)], dim=-1)
    bbox = torch.where(valid[..., None], bbox, inf)
    return roofline.bound_s(B * F * 9 * 4 + B * S * S * 4, roofline.box_pairs(bbox, S) * OPS_PER_PAIR)
