"""Axis-angle <-> rotation matrix (counterpart of
hifihr_tpu/geometry/rotations.py): to the matrix through the quaternion
path, with manopth's norm(x + 1e-8); back through the trace and the
skew-symmetric part (DART's loader takes its root rotation so)."""

from __future__ import annotations

import torch


def axis_angle_to_quaternion(axisang: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 4) unit quaternion (w, x, y, z)."""
    angle = torch.linalg.vector_norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3, 3) rotation matrix."""
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ]
    return torch.stack(rows, dim=-1).reshape(quat.shape[:-1] + (3, 3))


def axis_angle_to_matrix(axisang: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3), smooth at theta ~ 0."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axisang))


def matrix_to_axis_angle(mat: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) axis-angle."""
    trace = mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0 + eps, 1.0 - eps)
    angle = torch.arccos(cos)
    axis = torch.stack(
        [
            mat[..., 2, 1] - mat[..., 1, 2],
            mat[..., 0, 2] - mat[..., 2, 0],
            mat[..., 1, 0] - mat[..., 0, 1],
        ],
        dim=-1,
    )
    sin = torch.sin(angle)[..., None]
    axis = axis / torch.where(torch.abs(sin) < eps, 1.0, 2.0 * sin)
    return axis * angle[..., None]
