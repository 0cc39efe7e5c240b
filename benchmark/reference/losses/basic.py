"""Loss primitives (counterpart of hifihr_tpu/losses/basic.py; each mirrors a
reference formula).

References: utils/losses_util.py (tsa_pose_loss :139-215, bone_direction_loss
:217-283, edge_length_loss :285-301, iou :366-378), losses.py (Huber-like 2D
distance :46-56), pytorch3d mesh_laplacian_smoothing through the precomputed
uniform Laplacian (benchmark.reference.render.mesh.uniform_laplacian).
Index lists and limits are cached device constants, so no call copies from
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import constant
from benchmark.reference.geometry.joints import FREI_BONES

_PI = float(np.pi)
_D = _PI / 180.0

# tilt-swing-azimuth per-joint hinge limits (radians), 16 joints x 3,
# transcribed from reference utils/losses_util.py:180-215 (active variant)
_TSA_MAX = np.array(
    [[3.15, 0.01, 0.01]]
    + [[5 * _D, 10 * _D, 100 * _D], [5 * _D, 5 * _D, 100 * _D], [5 * _D, 5 * _D, 100 * _D]]  # index
    + [[5 * _D, 10 * _D, 100 * _D], [5 * _D, 5 * _D, 100 * _D], [5 * _D, 5 * _D, 100 * _D]]  # middle
    + [[5 * _D, 20 * _D, 100 * _D], [5 * _D, 5 * _D, 100 * _D], [5 * _D, 5 * _D, 100 * _D]]  # pinky
    + [[5 * _D, 10 * _D, 100 * _D], [5 * _D, 5 * _D, 100 * _D], [5 * _D, 5 * _D, 100 * _D]]  # ring
    + [[90 * _D, 3 * _PI / 16, _PI / 8], [5 * _D, 5 * _D, _PI / 8], [5 * _D, 5 * _D, 100 * _D]],  # thumb
    dtype=np.float32,
)
_TSA_MIN = np.array(
    [[3.13, -0.01, -0.01]]
    + [[-5 * _D, -10 * _D, -10 * _D], [-5 * _D, -5 * _D, -10 * _D], [-5 * _D, -5 * _D, -10 * _D]]
    + [[-5 * _D, -10 * _D, -10 * _D], [-5 * _D, -5 * _D, -10 * _D], [-5 * _D, -5 * _D, -10 * _D]]
    + [[-20 * _D, -10 * _D, -10 * _D], [-5 * _D, -5 * _D, -10 * _D], [-5 * _D, -5 * _D, -10 * _D]]
    + [[-5 * _D, -10 * _D, -10 * _D], [-5 * _D, -5 * _D, -10 * _D], [-5 * _D, -5 * _D, -10 * _D]]
    + [[0.0, -_PI / 8, -_PI / 8], [-5 * _D, -5 * _D, -_PI / 8], [-5 * _D, -5 * _D, -20 * _D]],
    dtype=np.float32,
)
_TSA_CHANNEL_W = np.array([1.0, 1.0, 2.0], dtype=np.float32)


def tsa_pose_loss(tsa_poses: torch.Tensor) -> torch.Tensor:
    """Hinge penalty outside per-joint angle limits. tsa_poses: (B, 16, 3)."""
    dev, dt = tsa_poses.device, tsa_poses.dtype
    hi = constant(_TSA_MAX, dev, dt)[None]
    lo = constant(_TSA_MIN, dev, dt)[None]
    err = (tsa_poses - hi).clamp(min=0.0) + (lo - tsa_poses).clamp(min=0.0)
    return (err * constant(_TSA_CHANNEL_W, dev, dt)).mean()


def bone_direction_loss(j2d: torch.Tensor, j2d_ref: torch.Tensor, conf: torch.Tensor) -> torch.Tensor:
    """Confidence-weighted squared difference of normalised bone vectors.

    j2d, j2d_ref: (B, 21, 2+) (FreiHAND order); conf: (B, 21, 1).
    Bone confidence = conf[parent] * conf[child] (losses_util.py:259-281).
    """
    pa = constant(FREI_BONES[:, 0], j2d.device, torch.int64)
    ch = constant(FREI_BONES[:, 1], j2d.device, torch.int64)

    def unit_bones(x):
        bones = x.index_select(1, ch) - x.index_select(1, pa)  # (B, 20, D)
        return bones / (torch.linalg.vector_norm(bones, dim=-1, keepdim=True) + 1e-4)

    bone_conf = conf.index_select(1, pa)[..., 0] * conf.index_select(1, ch)[..., 0]  # (B, 20)
    return (((unit_bones(j2d) - unit_bones(j2d_ref)) ** 2).sum(-1) * bone_conf).mean()


def edge_length_loss(pred: torch.Tensor, gt: torch.Tensor, faces) -> torch.Tensor:
    """Mean |edge_len(pred) - edge_len(gt)| over the 3 edges of every face."""
    faces = constant(faces, pred.device, torch.int64) if not torch.is_tensor(faces) else faces.long()

    def lengths(v):
        tri = v.index_select(1, faces.reshape(-1)).reshape(v.shape[0], faces.shape[0], 3, 3)
        d1 = torch.linalg.vector_norm(tri[:, :, 0] - tri[:, :, 1], dim=-1)
        d2 = torch.linalg.vector_norm(tri[:, :, 0] - tri[:, :, 2], dim=-1)
        d3 = torch.linalg.vector_norm(tri[:, :, 1] - tri[:, :, 2], dim=-1)
        return torch.stack([d1, d2, d3], dim=-1)

    return (lengths(pred) - lengths(gt)).abs().mean()


def iou_loss(sil_a: torch.Tensor, sil_b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """1 - mean IoU over the batch; sils (B, H, W) or (B, H, W, 1)."""
    a = sil_a.reshape(sil_a.shape[0], -1)
    b = sil_b.reshape(sil_b.shape[0], -1)
    inter = (a * b).sum(1)
    union = (a + b).sum(1) - inter
    return 1.0 - (inter / (union + eps)).mean()


def laplacian_loss(verts: torch.Tensor, laplacian: torch.Tensor) -> torch.Tensor:
    """Uniform-Laplacian smoothing: mean ||L v||_2 per vertex (pytorch3d
    mesh_laplacian_smoothing(method='uniform'), losses_util.py:340-364)."""
    lap = torch.einsum("uv,bvd->bud", laplacian, verts)
    return torch.linalg.vector_norm(lap, dim=-1).mean()


def huber_2d_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reference's piecewise 2D keypoint distance (losses.py:47-48):
    d < 5 px -> d^2/10 else d - 2.5. Returns (B, 21)."""
    d = torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12)
    return torch.where(d < 5.0, d * d / 10.0, d - 2.5)


def chamfer_loss(pred: torch.Tensor, gt: torch.Tensor) -> tuple:
    """Symmetric Chamfer distances ((B,), (B,)) between point sets
    (reference utils/losses_util.py:304-337 ChamferLoss)."""
    d2 = ((pred ** 2).sum(-1)[:, :, None] + (gt ** 2).sum(-1)[:, None, :]
          - 2.0 * torch.einsum("bnd,bmd->bnm", pred, gt))
    return d2.amin(dim=2).mean(dim=1), d2.amin(dim=1).mean(dim=1)
