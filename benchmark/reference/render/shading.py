"""Phong shading with one directional light, camera space (counterpart of
hifihr_tpu/render/shading.py with its default Materials).

pixel = texel * (light_ambient * 1.0 + light_diffuse * 0.8 * N.L)
        + light_specular * 0.2 * (V.R)^30 [* spec_map]

with N perturbed by a tangent-space normal map where one is given (NIMBLE's
appearance: diffuse, normal and specular maps).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import constant

# the JAX package's default Materials (grey, so one scalar per term)
MAT_AMBIENT, MAT_DIFFUSE, MAT_SPECULAR, MAT_SHININESS = 1.0, 0.8, 0.2, 30.0


class DirectionalLight(NamedTuple):
    ambient_color: torch.Tensor  # (B, 3)
    diffuse_color: torch.Tensor  # (B, 3)
    specular_color: torch.Tensor  # (B, 3)
    direction: torch.Tensor  # (B, 3) surface -> light

    @staticmethod
    def from_estimator(colors: torch.Tensor, directions: torch.Tensor) -> "DirectionalLight":
        return DirectionalLight(torch.full_like(colors, 0.5), colors,
                                torch.full_like(colors, 0.2), directions)

    @staticmethod
    def default(batch: int, dtype=torch.float32, device=None) -> "DirectionalLight":
        device = torch.get_default_device() if device is None else device

        def full(x):
            return torch.full((batch, 3), x, dtype=dtype, device=device)

        # a cached device constant: a fresh host copy would make the step wait
        direction = constant([[0.0, 0.0, -1.0]], device, dtype).repeat(batch, 1)
        return DirectionalLight(full(0.5), full(0.3), full(0.2), direction)


def _safe_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps inside the sqrt: finite where the vector is exactly zero
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def phong_shade(texels: torch.Tensor, normals: torch.Tensor, points: torch.Tensor,
                light: DirectionalLight, normal_map: torch.Tensor | None = None,
                tangents: torch.Tensor | None = None,
                spec_map: torch.Tensor | None = None) -> torch.Tensor:
    """texels, normals (unnormalised), points: (B, H, W, 3) -> rgb (B, H, W, 3).
    Optional maps: normal_map (B, H, W, 3) in [0, 1], tangent space, applied
    in the frame of the interpolated `tangents` (B, H, W, 3) made orthogonal
    to the normal; spec_map (B, H, W, 1) scales the specular term."""
    n = _safe_normalize(normals)
    if normal_map is not None and tangents is not None:
        t = _safe_normalize(tangents - (tangents * n).sum(-1, keepdim=True) * n)
        bt = torch.linalg.cross(n, t)
        nm = normal_map * 2.0 - 1.0
        n = _safe_normalize(t * nm[..., 0:1] + bt * nm[..., 1:2] + n * nm[..., 2:3])
    l = _safe_normalize(light.direction)[:, None, None, :]
    ndl_raw = (n * l).sum(-1, keepdim=True)
    ndl = ndl_raw.clamp(min=0.0)

    amb = MAT_AMBIENT * light.ambient_color[:, None, None, :]
    dif = MAT_DIFFUSE * light.diffuse_color[:, None, None, :] * ndl

    # view direction toward the camera at the origin; light reflected about n
    view = -_safe_normalize(points)
    reflect = -l + 2.0 * ndl_raw * n
    cos_alpha = (view * reflect).sum(-1, keepdim=True).clamp(min=0.0)
    cos_alpha = torch.where(ndl > 0, cos_alpha, torch.zeros_like(cos_alpha))
    spec = (MAT_SPECULAR * light.specular_color[:, None, None, :]
            * torch.pow(cos_alpha, MAT_SHININESS))
    if spec_map is not None:
        spec = spec * spec_map
    return texels * (amb + dif) + spec
