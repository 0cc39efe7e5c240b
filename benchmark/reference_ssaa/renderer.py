"""The reference's Phong renderer with the SSAA path (a frozen plain copy of
the port's render/renderer.py `_forward_ssaa`): project with the
intrinsics scaled by aa_factor -> the face selection at every pixel centre
of the supersampled image (raster.py, no gradient, outside the checkpoint)
-> barycentric interpolation of the vertex channels with the fragments'
camera points, and of the atlas corners -> the UV maps sampled per fragment
-> Phong -> RGB * mask, mask, depth -> aa_factor x aa_factor average pool.
The differentiable part is recomputed in backward (`torch.utils.checkpoint`),
as the port's is. MSAA renders as benchmark.reference's renderer does."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import constant
from benchmark.reference.render import renderer as msaa
from benchmark.reference.render.interpolate import (barycentric_coords, interpolate_attribute,
                                                    interpolate_face_attribute)
from benchmark.reference.render.raster import project_to_screen
from benchmark.reference.render.shading import DirectionalLight
from benchmark.reference_ssaa.raster import rasterize_face_id


def scale_intrinsics(K: torch.Tensor, s: float) -> torch.Tensor:
    """Pixel intrinsics of the image scaled by s: fx, fy, cx, cy times s."""
    return K * constant([[s, 1.0, s], [1.0, s, s], [1.0, 1.0, 1.0]], K.device, K.dtype)


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H / k, W / k, C), the mean of each k x k block."""
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))


class PhongRenderer(msaa.PhongRenderer):
    def select_faces_ssaa(self, verts_cam: torch.Tensor, K: torch.Tensor):
        """(face_id, zbuf) at the supersampled resolution; K holds the base
        image's intrinsics."""
        s = self.settings
        verts_screen = project_to_screen(verts_cam.detach(), scale_intrinsics(K, float(s.aa_factor)))
        return rasterize_face_id(verts_screen, self.faces, s.image_size * s.aa_factor)

    def forward(self, verts_cam, vert_colors, K, light=None, tex_coef=None, texture_image=None):
        if self.settings.aa_mode != "ssaa":
            return super().forward(verts_cam, vert_colors, K, light, tex_coef, texture_image)
        if light is None:
            light = DirectionalLight.default(verts_cam.shape[0], verts_cam.dtype, verts_cam.device)
        plan = self._plan(vert_colors, texture_image)
        s = self.settings
        K_big = scale_intrinsics(K, float(s.aa_factor))
        face_id, _ = self.select_faces_ssaa(verts_cam, K)

        def shade(verts_cam, vert_colors, texture_image):
            frag = barycentric_coords(face_id, project_to_screen(verts_cam, K_big), self.faces)
            pix = interpolate_attribute(frag, self._assemble(plan, verts_cam, vert_colors, include_points=True))
            pix_uv = None
            if plan.use_uv and self.face_uv is not None:
                pix_uv = interpolate_face_attribute(frag, face_id, self.face_uv)
            return _avg_pool(self._shade_pix(plan, pix, pix_uv, texture_image, frag["mask"], light), s.aa_factor)

        if not torch.is_grad_enabled():
            return shade(verts_cam, vert_colors, texture_image)
        return checkpoint(shade, verts_cam, vert_colors, texture_image, use_reentrant=False,
                          preserve_rng_state=False)
