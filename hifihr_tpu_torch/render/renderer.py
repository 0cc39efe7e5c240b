"""Phong renderer (counterpart of hifihr_tpu/render/renderer.py::
PhongRenderer with vertex colours), in two anti-aliasing modes:

- 'msaa': project with pixel intrinsics -> K1 face selection with
  aa_factor x aa_factor subsample coverage at base resolution -> barycentric
  interpolation of albedo and normals through K2 -> fragment positions from
  the pixel ray -> Phong shading -> RGB * coverage, coverage, depth.
  NIMBLE's corner path (`tex_coef` given and corner tables present, as JAX's
  `_render_corner`): the PCA appearance evaluated at the face corners
  (diffuse, tangent-space normal and spec weight, clipped to [0, 1]) rides
  the packed row beside the vertex tangents and normals, 9 + 3 (6 + 7) = 48
  floats, and the shading applies the normal and spec maps; the gradient
  reaches `tex_coef` through K3.
- 'ssaa' (reference-exact): project with the intrinsics scaled by
  aa_factor -> K4 face selection at every pixel centre of the supersampled
  image (no gradient, outside the checkpoint) -> barycentric interpolation
  of [albedo | normals | points] through K2 -> Phong shading with the
  interpolated points -> RGB * mask, mask, depth -> aa_factor x aa_factor
  average pool. The differentiable part is recomputed in backward
  (`torch.utils.checkpoint`, JAX's `jax.checkpoint`): its supersampled
  activations are 9x the MSAA path's.

Faces are always put in the Morton order of the template: face ids, and so
the rasterisers' tie rules, are internal to the renderer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hifihr_tpu_torch import constant
from hifihr_tpu_torch.render.interpolate import (barycentric_coords, fragment_interpolate,
                                                 interpolate_attribute)
from hifihr_tpu_torch.render.mesh import vertex_normals, vertex_normals_and_tangents
from hifihr_tpu_torch.render.raster import project_to_screen, rasterize_face_id
from hifihr_tpu_torch.render.raster_msaa import rasterize_msaa
from hifihr_tpu_torch.render.shading import DirectionalLight, phong_shade


class RenderSettings(NamedTuple):
    image_size: int = 224
    aa_factor: int = 3  # subsample grid per pixel axis
    aa_mode: str = "msaa"  # 'msaa' | 'ssaa'


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


def _scale_intrinsics(K: torch.Tensor, s: float) -> torch.Tensor:
    """Pixel intrinsics of the image scaled by s: fx, fy, cx, cy times s."""
    return K * constant([[s, 1.0, s], [1.0, s, s], [1.0, 1.0, 1.0]], K.device, K.dtype)


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H / k, W / k, C), the mean of each k x k block."""
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))


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

    def __init__(self, faces, sort_template, settings: RenderSettings = RenderSettings(),
                 face_uv=None, corner_mean=None, corner_basis=None):
        """faces (F, 3); optional per-face tables, permuted with the faces:
        face_uv (F, 3, 2) atlas corners, and the corner-sampled appearance
        corner_mean (F, 3, 7) and corner_basis (F, 3, 7, T) (NIMBLE)."""
        super().__init__()
        order = morton_face_order(sort_template, faces)

        def buf(name, a, dtype=torch.float32):
            t = None if a is None else torch.as_tensor(np.asarray(a)[order], dtype=dtype)
            self.register_buffer(name, t, persistent=False)

        buf("faces", faces, torch.int64)
        buf("face_uv", face_uv)
        buf("corner_mean", corner_mean)
        buf("corner_basis", corner_basis)
        if corner_mean is not None and (face_uv is None or np.shape(corner_mean)[-1] != 7):
            raise ValueError("the corner path needs face_uv and 7 appearance channels "
                             "(diffuse, normal map, spec weight)")
        self.settings = settings

    def select_faces(self, verts_cam: torch.Tensor, K: torch.Tensor):
        """(face_id, coverage) at base resolution through K1."""
        s = self.settings
        verts_screen = project_to_screen(verts_cam.detach(), K)
        face_id, coverage, _ = rasterize_msaa(verts_screen, self.faces, s.image_size,
                                              samples=s.aa_factor)
        return face_id, coverage

    def select_faces_ssaa(self, verts_cam: torch.Tensor, K: torch.Tensor):
        """(face_id, zbuf) at the supersampled resolution through K4; K holds
        the base image's intrinsics."""
        s = self.settings
        K_big = _scale_intrinsics(K, float(s.aa_factor))
        verts_screen = project_to_screen(verts_cam.detach(), K_big)
        return rasterize_face_id(verts_screen, self.faces, s.image_size * s.aa_factor)

    def rasterize(self, verts_cam: torch.Tensor, K: torch.Tensor):
        """(frag, verts_screen) at the supersampled resolution: frag is
        `barycentric_coords` of K4's face selection."""
        K_big = _scale_intrinsics(K, float(self.settings.aa_factor))
        face_id, _ = self.select_faces_ssaa(verts_cam, K)
        verts_screen = project_to_screen(verts_cam, K_big)
        return barycentric_coords(face_id, verts_screen, self.faces), verts_screen

    def forward(self, verts_cam: torch.Tensor, vert_colors: torch.Tensor, K: torch.Tensor,
                light: DirectionalLight | None = None,
                tex_coef: torch.Tensor | None = None) -> torch.Tensor:
        """verts_cam (B, V, 3) camera space (z > 0 forward), vert_colors
        (B, V, 3) albedo, K (B, 3, 3) pixel intrinsics, tex_coef (B, T) PCA
        appearance coefficients (NIMBLE) ->
        (B, S, S, 5) [rgb * coverage, coverage, camera z (0 on background)];
        in 'ssaa' mode each channel is the mean of its aa_factor^2
        supersampled pixels. With tex_coef and corner tables, MSAA renders
        through the corner path and vert_colors is not read."""
        s = self.settings
        if light is None:
            light = DirectionalLight.default(verts_cam.shape[0], verts_cam.dtype,
                                             verts_cam.device)
        if s.aa_mode == "msaa" and tex_coef is not None and self.corner_mean is not None:
            return self._forward_corner(verts_cam, K, light, tex_coef)
        if s.aa_mode == "ssaa":
            return self._forward_ssaa(verts_cam, vert_colors, K, light)
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

    def corner_appearance(self, tex_coef: torch.Tensor) -> torch.Tensor:
        """The PCA appearance at every face corner, (B, F, 3, 7) in [0, 1],
        from tex_coef (B, T)."""
        T = self.corner_basis.shape[-1]
        return (self.corner_mean[None] + torch.einsum(
            "fkct,bt->bfkc", self.corner_basis, tex_coef[:, :T])).clamp(0.0, 1.0)

    def _forward_corner(self, verts_cam, K, light, tex_coef):
        face_id, coverage = self.select_faces(verts_cam, K)
        corner_tex = self.corner_appearance(tex_coef)
        normals, tangents = vertex_normals_and_tangents(verts_cam, self.faces, self.face_uv)
        # pix: [tangent 3 | normal 3 | diffuse 3 | normal map 3 | spec 1]
        pix, mask, zbuf = fragment_interpolate(face_id, project_to_screen(verts_cam, K), self.faces,
                                               torch.cat([tangents, normals], dim=-1),
                                               corner_attrs_batched=corner_tex)
        pix_p = _pixel_ray_points(zbuf, mask, K, self.settings.image_size)
        sampled = pix[..., 6:13].clamp(0.0, 1.0)
        rgb = phong_shade(sampled[..., :3], pix[..., 3:6], pix_p, light, normal_map=sampled[..., 3:6],
                          tangents=pix[..., :3], spec_map=sampled[..., 6:7])
        rgb = rgb * coverage[..., None]
        covered = (coverage > 0).to(rgb.dtype)[..., None]
        return torch.cat([rgb, coverage[..., None], pix_p[..., 2:3] * covered], dim=-1)

    def _forward_ssaa(self, verts_cam, vert_colors, K, light):
        s = self.settings
        K_big = _scale_intrinsics(K, float(s.aa_factor))
        face_id, _ = self.select_faces_ssaa(verts_cam, K)
        nc = vert_colors.shape[-1]

        def shade(verts_cam, vert_colors):
            frag = barycentric_coords(face_id, project_to_screen(verts_cam, K_big), self.faces)
            attrs = torch.cat([vert_colors, vertex_normals(verts_cam, self.faces), verts_cam], dim=-1)
            pix = interpolate_attribute(frag, attrs)
            mask = frag["mask"]
            pix_p = pix[..., nc + 3:nc + 6]
            rgb = phong_shade(pix[..., :nc], pix[..., nc:nc + 3], pix_p, light) * mask[..., None]
            covered = (mask > 0).to(rgb.dtype)[..., None]
            rgba = torch.cat([rgb, mask[..., None], pix_p[..., 2:3] * covered], dim=-1)
            return _avg_pool(rgba, s.aa_factor)

        if not torch.is_grad_enabled():  # eval under inference_mode: nothing to recompute
            return shade(verts_cam, vert_colors)
        return checkpoint(shade, verts_cam, vert_colors, use_reentrant=False, preserve_rng_state=False)

