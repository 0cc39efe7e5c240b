"""Barycentric recompute + attribute interpolation from a per-pixel face
selection (counterpart of hifihr_tpu/render/interpolate.py).

MSAA path: `fragment_interpolate` (per-vertex attributes, a static UV
atlas and NIMBLE's per-face-corner appearance), one K2 fetch of a packed
face table,
barycentrics projected onto the simplex.
SSAA path: `barycentric_coords`, `interpolate_attribute` and
`interpolate_face_attribute`, with JAX's semantics: area kept away from 0
at +1e-12, barycentrics clipped to [-4, 5], zbuf = 1 / denom.

Every per-pixel fetch goes through K2 (`gather_rows`, backward K3) with
idx = face_id, so a background pixel (-1) reads a zero row and sends no
gradient. JAX indexes background pixels with face 0 instead; there its
bary and tri differ from the port's, but every output is masked to 0 on
background, so the interpolated values and all gradients are the same.
"""

from __future__ import annotations

import torch

from benchmark.reference.render.gather import gather_rows
from benchmark.reference.render.mesh import gather_face_rows


def pack_face_table(verts_screen: torch.Tensor, faces: torch.Tensor, vert_attrs: torch.Tensor,
                    corner_attrs: torch.Tensor | None = None,
                    corner_attrs_static: torch.Tensor | None = None) -> torch.Tensor:
    """(B, F, 9 + 3D) rows [a_uvz b_uvz c_uvz | a_attrs b_attrs c_attrs]:
    each face's screen corners and corner attributes, the table K2 reads.
    A corner's attributes are its vertex's vert_attrs (B, V, Dv), then the
    face corner's batch-constant corner_attrs_static (F, 3, Ds), broadcast
    over the batch, then its own corner_attrs (B, F, 3, Dc), each where
    given, so D = Dv + Ds + Dc (the JAX package's channel order)."""
    B, F = vert_attrs.shape[0], faces.shape[0]
    both = gather_face_rows(torch.cat([verts_screen, vert_attrs], dim=-1), faces).reshape(B, F, 3, -1)
    extra = []
    if corner_attrs_static is not None:
        extra.append(corner_attrs_static.to(both.dtype)[None].expand(B, F, 3, corner_attrs_static.shape[-1]))
    if corner_attrs is not None:
        extra.append(corner_attrs.to(both.dtype))
    if extra:
        both = torch.cat([both] + extra, dim=-1)
    tri = both[..., :3].reshape(B, F, 9)
    return torch.cat([tri, both[..., 3:].reshape(B, F, -1)], dim=-1).contiguous()


def fragment_interpolate(face_id: torch.Tensor, verts_screen: torch.Tensor,
                         faces: torch.Tensor, vert_attrs: torch.Tensor,
                         corner_attrs_static: torch.Tensor | None = None,
                         corner_attrs_batched: torch.Tensor | None = None):
    """face_id (B, H, W) int32 (-1 = background), verts_screen (B, V, 3)
    [u, v, z], faces (F, 3), vert_attrs (B, V, Dv), and optionally
    batch-constant per-face-corner attributes corner_attrs_static
    (F, 3, Ds) (a seamed UV atlas) and differentiable ones
    corner_attrs_batched (B, F, 3, Dc) -> (pix_attrs (B, H, W, Dv + Ds + Dc),
    mask (B, H, W), zbuf (B, H, W)).

    Fetches each pixel's row of the packed face table with K2
    (`gather_rows`, whose backward is K3), which gives zero rows for
    background pixels; `interpolate_rows` masks them. Each channel is
    interpolated on its own, so the order of the channels in the row does
    not change the values."""
    B, H, W = face_id.shape
    table = pack_face_table(verts_screen, faces, vert_attrs, corner_attrs_batched, corner_attrs_static)
    pix = gather_rows(table, _pixel_rows(face_id))
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


def _pixel_rows(face_id: torch.Tensor) -> torch.Tensor:
    """K2's (B, H * W) int32 index from a (B, H, W) face selection."""
    return face_id.reshape(face_id.shape[0], -1).to(torch.int32).contiguous()


def barycentric_coords(face_id: torch.Tensor, verts_screen: torch.Tensor, faces: torch.Tensor) -> dict:
    """face_id (B, H, W) int32 (-1 = background), verts_screen (B, V, 3)
    [u, v, z] (differentiable), faces (F, 3) -> dict of
      mask (B, H, W) coverage, bary (B, H, W, 3) perspective-correct
      barycentrics, zbuf (B, H, W) camera depth (inf on background),
      tri (B, H, W, 3, 3) the pixel's screen triangle (zeros on
      background), pix_faces (B, H, W, 3) its vertex ids (face 0's on
      background, as JAX), and face_id and faces for the interpolators."""
    B, H, W = face_id.shape
    dt = verts_screen.dtype
    table = gather_face_rows(verts_screen, faces).contiguous()  # (B, F, 9)
    tri = gather_rows(table, _pixel_rows(face_id)).reshape(B, H, W, 3, 3)
    pix_faces = faces[face_id.clamp(min=0).long()]

    u = (torch.arange(W, dtype=dt, device=tri.device) + 0.5).view(1, 1, W)
    v = (torch.arange(H, dtype=dt, device=tri.device) + 0.5).view(1, H, 1)
    ax, ay, az = tri[..., 0, 0], tri[..., 0, 1], tri[..., 0, 2]
    bx, by, bz = tri[..., 1, 0], tri[..., 1, 1], tri[..., 1, 2]
    cx, cy, cz = tri[..., 2, 0], tri[..., 2, 1], tri[..., 2, 2]
    e0 = (cx - bx) * (v - by) - (cy - by) * (u - bx)
    e1 = (ax - cx) * (v - cy) - (ay - cy) * (u - cx)
    e2 = (bx - ax) * (v - ay) - (by - ay) * (u - ax)
    area = e0 + e1 + e2
    area = torch.where(area.abs() < 1e-12, torch.full_like(area, 1e-12), area)
    w_affine = torch.stack([e0, e1, e2], dim=-1) / area[..., None]

    # perspective-correct weights: wp_i ~ w_i / z_i
    z_tri = torch.stack([az, bz, cz], dim=-1)
    z_tri = torch.where(z_tri.abs() < 1e-8, torch.full_like(z_tri, 1e-8), z_tri)
    wp = w_affine / z_tri
    denom = wp.sum(-1, keepdim=True)
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    bary = (wp / denom).clamp(-4.0, 5.0)  # sliver guard

    covered = face_id >= 0
    zbuf = torch.where(covered, 1.0 / denom[..., 0], torch.full_like(az, float("inf")))
    return {"mask": covered.to(dt), "bary": bary, "zbuf": zbuf, "tri": tri, "pix_faces": pix_faces,
            "face_id": face_id, "faces": faces}


def _interpolate_corners(frag: dict, table: torch.Tensor) -> torch.Tensor:
    """Per-pixel sum of bary-weighted corner rows of a (B, F, 3D) table,
    masked to 0 on background -> (B, H, W, D)."""
    B, H, W = frag["face_id"].shape
    D = table.shape[-1] // 3
    corners = gather_rows(table.contiguous(), _pixel_rows(frag["face_id"])).reshape(B, H, W, 3, D)
    out = (frag["bary"][..., None] * corners).sum(-2)
    return out * frag["mask"][..., None]


def interpolate_attribute(frag: dict, vert_attrs: torch.Tensor) -> torch.Tensor:
    """Interpolate per-vertex attributes (B, V, D) (differentiable) at covered
    pixels -> (B, H, W, D)."""
    return _interpolate_corners(frag, gather_face_rows(vert_attrs, frag["faces"]))


def interpolate_face_attribute(frag: dict, face_id: torch.Tensor, face_attrs: torch.Tensor) -> torch.Tensor:
    """Interpolate per-face-corner attributes (F, 3, D), batch-constant (a
    seamed UV atlas: one vertex may carry other values in other faces), at
    the pixels of `face_id` -> (B, H, W, D)."""
    F, _, D = face_attrs.shape
    table = face_attrs.reshape(1, F, 3 * D).expand(face_id.shape[0], F, 3 * D)
    return _interpolate_corners(dict(frag, face_id=face_id), table)
