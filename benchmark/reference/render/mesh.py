"""Mesh helpers for a fixed-topology hand mesh (counterpart of
hifihr_tpu/render/mesh.py).

The TPU package applies a small mesh's topology as exact one-hot matmuls,
and gathers a large mesh's face corners with its Pallas row gather
(`gather_mxu.gather_rows`) on the TPU. The port follows the same split by
size: a small mesh (MANO) gathers its corners with `index_select`, a large
one (NIMBLE, 3 F V = 214 M) with K2 (`render.gather.gather_rows`, backward
K3). The corner accumulation is an fp32 `index_add_` for both, where JAX
takes a bf16 incidence matmul for the large mesh (so its NIMBLE normals and
tangents carry bf16 rounding; the port's do not).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.render.gather import gather_rows

# 3 F V above which JAX leaves the one-hot matmul (hifihr_tpu/render/mesh.py:19)
ONEHOT_LIMIT = 8_000_000


def gather_face_rows(x: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """x (B, V, D), faces (F, 3) -> (B, F, 3D) packed corner rows
    [a_0..a_D b_0..b_D c_0..c_D]. A mesh with 3 F V over ONEHOT_LIMIT goes
    through K2 with idx = the flat faces for every image."""
    B, V, D = x.shape
    F = faces.shape[0]
    if 3 * F * V <= ONEHOT_LIMIT:
        return x.index_select(1, faces.reshape(-1)).reshape(B, F, 3 * D)
    idx = faces.reshape(1, 3 * F).to(torch.int32).expand(B, 3 * F).contiguous()
    return gather_rows(x.contiguous(), idx).reshape(B, F, 3 * D)


def accumulate_corners(per_face: torch.Tensor, faces: torch.Tensor, n_verts: int) -> torch.Tensor:
    """Sum per-face values into each face's 3 corner vertices:
    (B, F, D) -> (B, V, D), in fp32."""
    B, F, D = per_face.shape
    out = per_face.new_zeros((B, n_verts, D))
    src = per_face.unsqueeze(2).expand(B, F, 3, D).reshape(B, 3 * F, D)
    return out.index_add_(1, faces.reshape(-1), src)


def _unit(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def face_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unnormalised face normals: (B, F, 3)."""
    B, _, D = verts.shape
    tri = gather_face_rows(verts, faces).reshape(B, faces.shape[0], 3, D)
    return torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals, (B, V, 3), unit length."""
    # eps inside the sqrt: finite for degenerate (zero-normal) vertices
    return _unit(accumulate_corners(face_normals(verts, faces), faces, verts.shape[1]), 1e-20)


def _face_tangents(tri: torch.Tensor, face_uv: torch.Tensor) -> torch.Tensor:
    """Per-face UV-aligned tangent from the corners tri (B, F, 3, 3) and the
    atlas corners face_uv (F, 3, 2): T solves [e1; e2] = [duv1; duv2] [T; Bt]."""
    e1 = tri[:, :, 1] - tri[:, :, 0]
    e2 = tri[:, :, 2] - tri[:, :, 0]
    duv1 = face_uv[:, 1] - face_uv[:, 0]  # (F, 2)
    duv2 = face_uv[:, 2] - face_uv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    r = 1.0 / torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    return (e1 * duv2[None, :, 1, None] - e2 * duv1[None, :, 1, None]) * r[None, :, None]


def vertex_tangents(verts: torch.Tensor, faces: torch.Tensor, face_uv: torch.Tensor) -> torch.Tensor:
    """UV-aligned per-vertex tangents, (B, V, 3), unit length."""
    B, V, _ = verts.shape
    tri = gather_face_rows(verts, faces).reshape(B, faces.shape[0], 3, 3)
    return _unit(accumulate_corners(_face_tangents(tri, face_uv), faces, V), 1e-12)


def vertex_normals_and_tangents(verts: torch.Tensor, faces: torch.Tensor, face_uv: torch.Tensor):
    """(vertex_normals, vertex_tangents), each (B, V, 3) unit length, from
    one corner gather of verts and one corner accumulation of both fields."""
    B, V, _ = verts.shape
    tri = gather_face_rows(verts, faces).reshape(B, faces.shape[0], 3, 3)
    fn = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0])
    acc = accumulate_corners(torch.cat([fn, _face_tangents(tri, face_uv)], dim=-1), faces, V)
    return _unit(acc[..., :3], 1e-20), _unit(acc[..., 3:], 1e-12)


def uniform_laplacian(num_verts: int, faces) -> torch.Tensor:
    """Dense uniform Laplacian L (V, V), fp32: (L @ v)_i = mean over the
    neighbours j of i of v_j, minus v_i. Fixed topology, so it is built once
    on the host (the `triangle` loss's operator)."""
    faces = np.asarray(faces)
    adj = np.zeros((num_verts, num_verts), np.float32)
    for a, b in ((0, 1), (1, 2), (2, 0)):
        adj[faces[:, a], faces[:, b]] = 1.0
        adj[faces[:, b], faces[:, a]] = 1.0
    deg = adj.sum(1)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    lap = adj * inv_deg[:, None] - np.diag((deg > 0).astype(np.float32))
    return torch.from_numpy(lap.astype(np.float32))
