"""Perspective and orthographic projection (counterpart of
hifihr_tpu/geometry/projection.py)."""

from __future__ import annotations

import torch


def perspective_project(xyz: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3) camera-space points, K (B, 3, 3) -> (B, N, 2) pixels."""
    uvw = torch.einsum("bij,bnj->bni", K, xyz)
    return uvw[..., :2] / uvw[..., 2:3]


def orthographic_project(points3d: torch.Tensor, ortho_cam: torch.Tensor) -> torch.Tensor:
    """DART's fitted orthographic camera: points3d (B, N, 3), ortho_cam
    (B, 3) = [s, tu, tv] -> (B, N, 2) with u = s x + tu, v = s y + tv."""
    s = ortho_cam[:, 0:1]
    u = s * points3d[..., 0] + ortho_cam[:, 1:2]
    v = s * points3d[..., 1] + ortho_cam[:, 2:3]
    return torch.stack([u, v], dim=-1)
