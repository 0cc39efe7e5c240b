"""Perspective projection (counterpart of hifihr_tpu/geometry/projection.py)."""

from __future__ import annotations

import torch


def perspective_project(xyz: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3) camera-space points, K (B, 3, 3) -> (B, N, 2) pixels."""
    uvw = torch.einsum("bij,bnj->bni", K, xyz)
    return uvw[..., :2] / uvw[..., 2:3]
