"""Barycentric recompute + attribute interpolation from a per-pixel face
selection (counterpart of hifihr_tpu/render/interpolate.py::
fragment_interpolate, per-vertex attributes only)."""

from __future__ import annotations

import torch

from hifihr_tpu_torch.render.gather import gather_rows
from hifihr_tpu_torch.render.mesh import gather_face_rows


def pack_face_table(verts_screen: torch.Tensor, faces: torch.Tensor,
                    vert_attrs: torch.Tensor) -> torch.Tensor:
    """(B, F, 9 + 3D) rows [a_uvz b_uvz c_uvz | a_attrs b_attrs c_attrs]:
    each face's screen corners and corner attributes, the table K2 reads."""
    D = vert_attrs.shape[-1]
    both = gather_face_rows(torch.cat([verts_screen, vert_attrs], dim=-1), faces)
    w3 = 3 + D
    tri = torch.cat([both[..., k * w3:k * w3 + 3] for k in range(3)], dim=-1)
    corner_attrs = torch.cat([both[..., k * w3 + 3:(k + 1) * w3] for k in range(3)], dim=-1)
    return torch.cat([tri, corner_attrs], dim=-1).contiguous()


def fragment_interpolate(face_id: torch.Tensor, verts_screen: torch.Tensor,
                         faces: torch.Tensor, vert_attrs: torch.Tensor):
    """face_id (B, H, W) int32 (-1 = background), verts_screen (B, V, 3)
    [u, v, z], faces (F, 3), vert_attrs (B, V, D) ->
    (pix_attrs (B, H, W, D), mask (B, H, W), zbuf (B, H, W)).

    Fetches each pixel's row of the packed face table with K2
    (`gather_rows`, whose backward is K3), which gives zero rows for
    background pixels; `interpolate_rows` masks them."""
    B, H, W = face_id.shape
    table = pack_face_table(verts_screen, faces, vert_attrs)
    pix = gather_rows(table, face_id.reshape(B, H * W).to(torch.int32).contiguous())
    return interpolate_rows(face_id, pix.reshape(B, H, W, table.shape[-1]))


def interpolate_rows(face_id: torch.Tensor, pix: torch.Tensor):
    """The barycentric recompute and interpolation on each pixel's fetched
    row: face_id (B, H, W), pix (B, H, W, 9 + 3D) -> (pix_attrs (B, H, W, D),
    mask (B, H, W), zbuf (B, H, W))."""
    H, W = face_id.shape[1:]
    D = (pix.shape[-1] - 9) // 3
    dt = pix.dtype
    u = (torch.arange(W, dtype=dt, device=pix.device) + 0.5).view(1, 1, W)
    v = (torch.arange(H, dtype=dt, device=pix.device) + 0.5).view(1, H, 1)
    ax, ay, az = pix[..., 0], pix[..., 1], pix[..., 2]
    bx, by, bz = pix[..., 3], pix[..., 4], pix[..., 5]
    cx, cy, cz = pix[..., 6], pix[..., 7], pix[..., 8]
    e0 = (cx - bx) * (v - by) - (cy - by) * (u - bx)
    e1 = (ax - cx) * (v - cy) - (ay - cy) * (u - cx)
    e2 = (bx - ax) * (v - ay) - (by - ay) * (u - ax)
    area = e0 + e1 + e2
    # a face under 1e-4 px^2 carries no visual signal: constant area, so no
    # 1/area gradient, and uniform barycentrics
    degenerate = area.abs() < 1e-4
    area_safe = torch.where(degenerate, torch.ones_like(area), area)
    w_affine = torch.stack([e0, e1, e2], dim=-1) / area_safe[..., None]

    z_tri = torch.stack([az, bz, cz], dim=-1)
    z_tri = torch.where(z_tri.abs() < 1e-8, torch.full_like(z_tri, 1e-8), z_tri)
    wp = w_affine / z_tri
    denom = wp.sum(-1, keepdim=True)
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    bary = wp / denom  # perspective-correct
    # simplex projection: MSAA selects faces whose pixel centre may lie
    # outside the face, where raw barycentrics extrapolate
    bary = bary.clamp(0.0, 1.0)
    ssum = bary.sum(-1, keepdim=True)
    good = (~degenerate[..., None]) & (ssum > 0.3)
    bary = torch.where(good, bary / ssum.clamp(min=0.3), torch.full_like(bary, 1.0 / 3.0))

    out = (bary[..., 0:1] * pix[..., 9:9 + D] + bary[..., 1:2] * pix[..., 9 + D:9 + 2 * D]
           + bary[..., 2:3] * pix[..., 9 + 2 * D:9 + 3 * D])
    covered = face_id >= 0
    mask = covered.to(dt)
    zbuf = torch.where(covered, (bary * z_tri).sum(-1), torch.full_like(az, float("inf")))
    return out * mask[..., None], mask, zbuf
