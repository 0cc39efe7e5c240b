"""Mesh helpers for a fixed-topology hand mesh (counterpart of
hifihr_tpu/render/mesh.py).

The TPU package applies the static topology as one-hot matmuls because TPU
row gathers and scatters are slow; here the corner gather is `index_select`
and the corner accumulation an fp32 `index_add_`, both exact up to the order
of the sums.
"""

from __future__ import annotations

import torch


def gather_face_rows(x: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """x (B, V, D), faces (F, 3) -> (B, F, 3D) packed corner rows
    [a_0..a_D b_0..b_D c_0..c_D]."""
    B, _, D = x.shape
    F = faces.shape[0]
    return x.index_select(1, faces.reshape(-1)).reshape(B, F, 3 * D)


def accumulate_corners(per_face: torch.Tensor, faces: torch.Tensor, n_verts: int) -> torch.Tensor:
    """Sum per-face values into each face's 3 corner vertices:
    (B, F, D) -> (B, V, D), in fp32."""
    B, F, D = per_face.shape
    out = per_face.new_zeros((B, n_verts, D))
    src = per_face.unsqueeze(2).expand(B, F, 3, D).reshape(B, 3 * F, D)
    return out.index_add_(1, faces.reshape(-1), src)


def face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unnormalised face normals: (B, F, 3)."""
    B, _, D = verts.shape
    tri = gather_face_rows(verts, faces).reshape(B, faces.shape[0], 3, D)
    return torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals, (B, V, 3), unit length."""
    v_normals = accumulate_corners(face_normals(verts, faces), faces, verts.shape[1])
    # eps inside the sqrt: finite for degenerate (zero-normal) vertices
    return v_normals * torch.rsqrt((v_normals * v_normals).sum(-1, keepdim=True) + 1e-20)
