"""Screen projection of the renderer (a copy of the port's
render/raster.py::project_to_screen; the reference renders MSAA only)."""

from __future__ import annotations

import torch


def project_to_screen(verts_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """verts_cam (B, V, 3), K (B, 3, 3) pixel intrinsics -> (B, V, 3) [u, v, z]."""
    z = verts_cam[..., 2:3]
    z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    u = K[:, None, 0, 0:1] * verts_cam[..., 0:1] / z_safe + K[:, None, 0, 2:3]
    v = K[:, None, 1, 1:2] * verts_cam[..., 1:2] / z_safe + K[:, None, 1, 2:3]
    return torch.cat([u, v, z], dim=-1)
