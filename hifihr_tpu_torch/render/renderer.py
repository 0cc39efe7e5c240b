"""Phong renderer (counterpart of hifihr_tpu/render/renderer.py::
PhongRenderer), in two anti-aliasing modes:

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
  average pool. On a CUDA tensor everything after K4 but the (B, V)-size
  projection and per-vertex channels is K6 (render/ssaa_shade.py), one
  launch forward and one backward that recomputes each fragment, so nothing
  of the supersampled size is kept. On a CPU tensor it is the plain composed
  pass (`_shade_plain`), recomputed in backward (`torch.utils.checkpoint`,
  JAX's `jax.checkpoint`): its supersampled activations are 9x the MSAA
  path's.

Spans (utils/profiling.py): `renderer.raster` around the face selection (K1
or K4); `renderer.shade` around the SSAA shade pass (its `.bwd` the pass's
backward). On the CPU `renderer.shade.recompute` is around its recompute,
which runs inside `renderer.shade.bwd` on the autograd engine's thread
(counted on `ssaa_shade.recomputes`), with `renderer.texture` inside it
(render/texture.py); on the card K6 counts its launches on
`ssaa_shade.kernel_launches`.

The UV path (a `texture_image` and a UV chart given; NIMBLE with
`nimble_corner_tex=False` in MSAA, and NIMBLE in SSAA): the channels are
[tangents, normals] (with the 7-channel maps) or [normals], the per-face
atlas corners interpolated beside them (in MSAA a static channel of K2's
row, 9 + 3 (6 + 2) = 33 floats for NIMBLE; in SSAA
`interpolate_face_attribute`), and each fragment samples the maps
(`texture.sample_texture`: a K2 fetch of the packed texel quads, K3 in
backward; in SSAA on the card, K6's own bilinear fetch); a per-vertex chart
alone rides the vertex channels.

Given a `sort_template`, the faces are put in the Morton order of the
template: face ids, and so the rasterisers' tie rules, are then internal to
the renderer. Without one (JAX's `sort_template=None`, as the turntable of
utils/visualize.py renders) the faces keep their given order, on which K1's
rule "ties go to the lower id" then depends.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hifihr_tpu_torch import constant
from hifihr_tpu_torch.render.interpolate import (barycentric_coords, fragment_interpolate,
                                                 interpolate_attribute, interpolate_face_attribute)
from hifihr_tpu_torch.render.mesh import vertex_normals, vertex_normals_and_tangents
from hifihr_tpu_torch.render.raster import project_to_screen, rasterize_face_id
from hifihr_tpu_torch.render.raster_msaa import rasterize_msaa
from hifihr_tpu_torch.render.shading import DirectionalLight, phong_shade
from hifihr_tpu_torch.render.ssaa_shade import ssaa_shade
from hifihr_tpu_torch.render.texture import sample_texture
from hifihr_tpu_torch.utils import profiling


class _Plan(NamedTuple):
    """Which channels a render interpolates (JAX renderer.py:227-240)."""

    use_uv: bool  # sample UV maps, not vertex colours
    with_maps: bool  # the normal and spec maps too (a 7-channel image)
    uv_in_verts: bool  # the per-vertex chart rides the vertex channels
    nc: int  # vertex colour channels (0 with UV)
    face_uv: torch.Tensor | None  # (F, 3, 2) atlas corners for the tangents


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
    (the template mesh) where one is given, else in their given order;
    called with batched geometry. The faces are a non-persistent buffer, so
    `.to(device)` moves them and the state dict does not hold them."""

    def __init__(self, faces, sort_template=None, settings: RenderSettings = RenderSettings(),
                 face_uv=None, corner_mean=None, corner_basis=None, vert_uv=None):
        """faces (F, 3); optional per-face tables, permuted with the faces:
        face_uv (F, 3, 2) atlas corners, and the corner-sampled appearance
        corner_mean (F, 3, 7) and corner_basis (F, 3, 7, T) (NIMBLE); and
        the per-vertex chart vert_uv (V, 2), used where face_uv is not
        given."""
        super().__init__()
        order = slice(None) if sort_template is None else morton_face_order(sort_template, faces)

        def buf(name, a, dtype=torch.float32):
            t = None if a is None else torch.as_tensor(np.asarray(a)[order], dtype=dtype)
            self.register_buffer(name, t, persistent=False)

        buf("faces", faces, torch.int64)
        buf("face_uv", face_uv)
        buf("corner_mean", corner_mean)
        buf("corner_basis", corner_basis)
        self.register_buffer("vert_uv", None if vert_uv is None else torch.as_tensor(
            np.asarray(vert_uv), dtype=torch.float32), persistent=False)
        if corner_mean is not None and (face_uv is None or np.shape(corner_mean)[-1] != 7):
            raise ValueError("the corner path needs face_uv and 7 appearance channels "
                             "(diffuse, normal map, spec weight)")
        self.settings = settings

    def select_faces(self, verts_cam: torch.Tensor, K: torch.Tensor):
        """(face_id, coverage) at base resolution through K1."""
        s = self.settings
        with profiling.span("renderer.raster"):
            verts_screen = project_to_screen(verts_cam.detach(), K)
            face_id, coverage, _ = rasterize_msaa(verts_screen, self.faces, s.image_size,
                                                  samples=s.aa_factor)
        return face_id, coverage

    def select_faces_ssaa(self, verts_cam: torch.Tensor, K: torch.Tensor):
        """(face_id, zbuf) at the supersampled resolution through K4; K holds
        the base image's intrinsics."""
        s = self.settings
        with profiling.span("renderer.raster"):
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
                light: DirectionalLight | None = None, tex_coef: torch.Tensor | None = None,
                texture_image: torch.Tensor | None = None) -> torch.Tensor:
        """verts_cam (B, V, 3) camera space (z > 0 forward), vert_colors
        (B, V, 3) albedo, K (B, 3, 3) pixel intrinsics, tex_coef (B, T) PCA
        appearance coefficients (NIMBLE), texture_image (B, Ht, Wt, 3 or 7)
        UV maps (diffuse, or diffuse + tangent-space normal + spec weight) ->
        (B, S, S, 5) [rgb * coverage, coverage, camera z (0 on background)];
        in 'ssaa' mode each channel is the mean of its aa_factor^2
        supersampled pixels. With tex_coef and corner tables, MSAA renders
        through the corner path; with texture_image and a UV chart, the UV
        maps are sampled per fragment; either way vert_colors is not read."""
        s = self.settings
        if light is None:
            light = DirectionalLight.default(verts_cam.shape[0], verts_cam.dtype,
                                             verts_cam.device)
        if s.aa_mode == "msaa" and tex_coef is not None and self.corner_mean is not None:
            return self._forward_corner(verts_cam, K, light, tex_coef)
        plan = self._plan(vert_colors, texture_image)
        if s.aa_mode == "ssaa":
            return self._forward_ssaa(plan, verts_cam, vert_colors, K, light, texture_image)
        face_id, coverage = self.select_faces(verts_cam, K)
        attrs = self._assemble(plan, verts_cam, vert_colors, include_points=False)
        # the atlas corners ride K2's row as a static channel, last
        static = self.face_uv if plan.use_uv and self.face_uv is not None else None
        pix, mask, zbuf = fragment_interpolate(face_id, project_to_screen(verts_cam, K), self.faces, attrs,
                                               corner_attrs_static=static)
        pix_uv = None
        if static is not None:
            pix, pix_uv = pix[..., :-2], pix[..., -2:]
        pix_p = _pixel_ray_points(zbuf, mask, K, s.image_size)
        return self._shade_pix(plan, pix, pix_uv, texture_image, coverage, light, pix_p)

    def _plan(self, vert_colors: torch.Tensor, texture_image: torch.Tensor | None) -> _Plan:
        """JAX's channel plan: UV maps where an image and a chart are given,
        with the normal and spec maps where the image has 7 channels."""
        use_uv = texture_image is not None and (self.face_uv is not None or self.vert_uv is not None)
        face_uv = self.face_uv
        if face_uv is None and self.vert_uv is not None:
            face_uv = self.vert_uv[self.faces]  # (F, 3, 2)
        return _Plan(use_uv, use_uv and texture_image.shape[-1] >= 7, use_uv and self.face_uv is None,
                     0 if use_uv else vert_colors.shape[-1], face_uv)

    def _assemble(self, plan: _Plan, verts_cam, vert_colors, include_points: bool) -> torch.Tensor:
        """The per-vertex channels: [vert colours | vert UV]?, [tangents,
        normals] with maps or [normals], [points]?."""
        parts = []
        if not plan.use_uv:
            parts.append(vert_colors)
        elif plan.uv_in_verts:
            parts.append(self.vert_uv[None].expand(verts_cam.shape[0], -1, -1))
        if plan.with_maps:
            normals, tangents = vertex_normals_and_tangents(verts_cam, self.faces, plan.face_uv)
            parts += [tangents, normals]
        else:
            parts.append(vertex_normals(verts_cam, self.faces))
        if include_points:
            parts.append(verts_cam)
        return torch.cat(parts, dim=-1)

    def _shade_pix(self, plan: _Plan, pix, pix_uv, texture_image, cover, light, pix_p=None) -> torch.Tensor:
        """Phong-shade the interpolated channels of `_assemble`: pix_uv
        (B, H, W, 2), else the UV at the head of pix; pix_p the fragments'
        camera points, else the tail of pix -> [rgb * cover, cover, depth]."""
        off = 0
        texels = normal_map = spec_map = tangent = None
        if not plan.use_uv:
            texels, off = pix[..., :plan.nc], plan.nc
        elif pix_uv is None:
            pix_uv, off = pix[..., 0:2], 2
        if plan.with_maps:
            tangent, off = pix[..., off:off + 3], off + 3
        pix_n = pix[..., off:off + 3]
        if pix_p is None:
            pix_p = pix[..., off + 3:off + 6]
        if plan.use_uv:
            sampled = sample_texture(texture_image, pix_uv)
            texels = sampled[..., :3]
            if plan.with_maps:
                normal_map, spec_map = sampled[..., 3:6], sampled[..., 6:7]
        rgb = phong_shade(texels, pix_n, pix_p, light, normal_map=normal_map, tangents=tangent,
                          spec_map=spec_map) * cover[..., None]
        covered = (cover > 0).to(rgb.dtype)[..., None]
        return torch.cat([rgb, cover[..., None], pix_p[..., 2:3] * covered], dim=-1)

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

    def _forward_ssaa(self, plan: _Plan, verts_cam, vert_colors, K, light, texture_image):
        s = self.settings
        K_big = _scale_intrinsics(K, float(s.aa_factor))
        face_id, _ = self.select_faces_ssaa(verts_cam, K)
        if face_id.is_cuda:
            return self._shade_k6(plan, face_id, verts_cam, vert_colors, K_big, light, texture_image)
        runs = [0]  # the shade's runs: the first is the forward, a later one checkpoint's recompute

        def shade(verts_cam, vert_colors, texture_image):
            recompute = runs[0] > 0
            runs[0] += 1
            if recompute:
                profiling.counters["ssaa_shade.recomputes"] += 1
            name = "renderer.shade.recompute" if recompute else "renderer.shade"
            with profiling.span(name, (verts_cam, vert_colors, texture_image)) as sp:
                out = self._shade_plain(plan, face_id, project_to_screen(verts_cam, K_big),
                                        self._assemble(plan, verts_cam, vert_colors, include_points=True),
                                        light, texture_image)
                sp.outputs(out)
            return out

        if not torch.is_grad_enabled():  # eval under inference_mode: nothing to recompute
            return shade(verts_cam, vert_colors, texture_image)
        return checkpoint(shade, verts_cam, vert_colors, texture_image, use_reentrant=False,
                          preserve_rng_state=False)

    def _shade_plain(self, plan: _Plan, face_id, verts_screen, attrs, light, texture_image) -> torch.Tensor:
        """The SSAA shade pass in plain PyTorch: K4's face_id (B, S, S), the
        screen vertices and `_assemble`'s channels with the points -> the
        pooled (B, S / aa, S / aa, 5) render."""
        frag = barycentric_coords(face_id, verts_screen, self.faces)
        pix = interpolate_attribute(frag, attrs)
        pix_uv = None
        if plan.use_uv and self.face_uv is not None:
            pix_uv = interpolate_face_attribute(frag, face_id, self.face_uv)
        return _avg_pool(self._shade_pix(plan, pix, pix_uv, texture_image, frag["mask"], light),
                         self.settings.aa_factor)

    def _shade_k6(self, plan: _Plan, face_id, verts_cam, vert_colors, K_big, light, texture_image):
        """The SSAA shade pass on the card: K6 (render/ssaa_shade.py), one
        launch each way; the projection and the per-vertex channels stay
        plain PyTorch at (B, V) size, inside the span."""
        kind = "colors" if not plan.use_uv else "chart" if plan.uv_in_verts else "atlas"
        with profiling.span("renderer.shade", (verts_cam, vert_colors, texture_image)) as sp:
            out = ssaa_shade(face_id, project_to_screen(verts_cam, K_big),
                             self._assemble(plan, verts_cam, vert_colors, include_points=True), self.faces,
                             light, self.settings.aa_factor, kind, plan.with_maps,
                             face_uv=self.face_uv if kind == "atlas" else None,
                             texture=texture_image.contiguous() if plan.use_uv else None)
            sp.outputs(out)
        return out
