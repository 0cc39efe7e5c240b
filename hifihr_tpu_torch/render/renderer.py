"""MSAA Phong renderer (counterpart of the MSAA branch of
hifihr_tpu/render/renderer.py::PhongRenderer).

Pipeline: project with pixel intrinsics -> K1 face selection with
aa_factor x aa_factor subsample coverage at base resolution -> barycentric
interpolation of albedo and normals through K2 -> fragment positions from
the pixel ray -> Phong shading -> RGB * coverage, coverage, depth.
Faces are always put in the Morton order of the template: face ids, and so
the rasteriser's tie rule, are internal to the renderer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from hifihr_tpu_torch.render.interpolate import fragment_interpolate
from hifihr_tpu_torch.render.mesh import vertex_normals
from hifihr_tpu_torch.render.raster import project_to_screen
from hifihr_tpu_torch.render.raster_msaa import rasterize_msaa
from hifihr_tpu_torch.render.shading import DirectionalLight, phong_shade


class RenderSettings(NamedTuple):
    image_size: int = 224
    aa_factor: int = 3  # subsample grid per pixel axis


def morton_face_order(template_verts, faces) -> np.ndarray:
    """Spatial (Morton / Z-curve) face permutation from template centroids,
    as hifihr_tpu.render.renderer.morton_face_order. Face ids, and so the
    rasteriser's tie rule, hold under this permutation."""
    template_verts = np.asarray(template_verts, np.float64)
    faces = np.asarray(faces)
    cent = template_verts[faces].mean(axis=1)
    q = ((cent - cent.min(0)) / (np.ptp(cent, axis=0) + 1e-9) * 1023).astype(np.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def _pixel_ray_points(zbuf, mask, K, size):
    """Fragment camera positions from the pixel ray and the interpolated
    depth: p = ((u - cx) / fx, (v - cy) / fy, 1) * z at pixel centres.
    zbuf (B, H, W) is inf on background (masked to 0 here)."""
    u = torch.arange(size, dtype=zbuf.dtype, device=zbuf.device) + 0.5
    z = torch.where(mask > 0, zbuf, torch.zeros_like(zbuf))
    fx = K[:, 0, 0][:, None, None]
    fy = K[:, 1, 1][:, None, None]
    cx = K[:, 0, 2][:, None, None]
    cy = K[:, 1, 2][:, None, None]
    x = (u[None, None, :] - cx) / fx * z
    y = (u[None, :, None] - cy) / fy * z
    return torch.stack([x, y, z], dim=-1)


class PhongRenderer(nn.Module):
    """Built once with the static faces, Morton-ordered over `sort_template`
    (the template mesh); called with batched geometry. The faces are a
    non-persistent buffer, so `.to(device)` moves them and the state dict
    does not hold them."""

    def __init__(self, faces, sort_template, settings: RenderSettings = RenderSettings()):
        super().__init__()
        faces = np.asarray(faces)
        faces = faces[morton_face_order(sort_template, faces)]
        self.register_buffer("faces", torch.as_tensor(faces, dtype=torch.int64),
                             persistent=False)
        self.settings = settings

    def select_faces(self, verts_cam: torch.Tensor, K: torch.Tensor):
        """(face_id, coverage) at base resolution through K1."""
        s = self.settings
        verts_screen = project_to_screen(verts_cam.detach(), K)
        face_id, coverage, _ = rasterize_msaa(verts_screen, self.faces, s.image_size,
                                              samples=s.aa_factor)
        return face_id, coverage

    def forward(self, verts_cam: torch.Tensor, vert_colors: torch.Tensor, K: torch.Tensor,
                 light: DirectionalLight | None = None) -> torch.Tensor:
        """verts_cam (B, V, 3) camera space (z > 0 forward), vert_colors
        (B, V, 3) albedo, K (B, 3, 3) pixel intrinsics ->
        (B, S, S, 5) [rgb * coverage, coverage, camera z (0 on background)]."""
        s = self.settings
        if light is None:
            light = DirectionalLight.default(verts_cam.shape[0], verts_cam.dtype,
                                             verts_cam.device)
        face_id, coverage = self.select_faces(verts_cam, K)

        verts_screen = project_to_screen(verts_cam, K)
        attrs = torch.cat([vert_colors, vertex_normals(verts_cam, self.faces)], dim=-1)
        pix, mask, zbuf = fragment_interpolate(face_id, verts_screen, self.faces, attrs)
        pix_p = _pixel_ray_points(zbuf, mask, K, s.image_size)
        nc = vert_colors.shape[-1]
        rgb = phong_shade(pix[..., :nc], pix[..., nc:nc + 3], pix_p, light)
        rgb = rgb * coverage[..., None]
        covered = (coverage > 0).to(rgb.dtype)[..., None]
        return torch.cat([rgb, coverage[..., None], pix_p[..., 2:3] * covered], dim=-1)
