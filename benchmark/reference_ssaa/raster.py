"""K4's plain version for the reference: the supersampled (SSAA) z-buffer
face selection, a frozen copy of the port's rule (the contract of its
render/raster.py), from the (pixel, face) pairs of each face's box.

At every pixel centre (u, v) = (col + 0.5, row + 0.5) of a B x S x S image:
  e0 = (cx - bx) (v - by) - (cy - by) (u - bx), e1 and e2 cyclically;
  area = (e0 + e1) + e2; w = e / where(|area| > 1e-12, area, 1e-12);
  inside when all three w >= 0, |area| > 1e-12 and min(az, bz, cz) > 1e-6;
  z = (w0 az + w1 bz) + w2 cz.
The inside face of least z wins, the lowest id on a tie. Outputs: face_id
(B, S, S) int32 (-1 on background), zbuf (B, S, S) float32 (inf on
background). No gradient.
"""

from __future__ import annotations

import torch

from benchmark.reference.render.mesh import gather_face_rows

PAIRS = 1 << 22  # (pixel, face) pairs evaluated at once
IMAGES = 16  # images a block


def face_triangles(verts_screen: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, F, 9) float32 rows [a_uvz b_uvz c_uvz], no gradient."""
    return gather_face_rows(verts_screen.detach(), faces).float().contiguous()


def _windows(tri: torch.Tensor, S: int):
    """Each face's pixel window, one pixel wider on each side than the
    columns and rows whose centres its box holds, clipped to the image:
    (first column and row (N, 2), last (N, 2), pairs (N,)) over the N = B F
    faces; no pairs for a face with a vertex at z <= 1e-6. A face with a
    box that is not finite gets the whole image."""
    zvalid = torch.minimum(torch.minimum(tri[:, 2], tri[:, 5]), tri[:, 8]) > 1e-6
    lo = torch.stack([tri[:, 0::3].amin(-1), tri[:, 1::3].amin(-1)], dim=-1)
    hi = torch.stack([tri[:, 0::3].amax(-1), tri[:, 1::3].amax(-1)], dim=-1)
    finite = torch.isfinite(lo).all(-1) & torch.isfinite(hi).all(-1)
    lo = torch.where(finite[:, None], (lo - 0.5).floor() - 1, torch.zeros_like(lo)).clamp(0, S)
    hi = torch.where(finite[:, None], (hi - 0.5).floor() + 1, torch.full_like(hi, S - 1)).clamp(-1, S - 1)
    lo, hi = lo.long(), hi.long()
    width = (hi - lo + 1).clamp(min=0)
    counts = torch.where(zvalid, width[:, 0] * width[:, 1], torch.zeros_like(width[:, 0]))
    return lo, width, counts


def _select_block(tri: torch.Tensor, S: int):
    B, F, _ = tri.shape
    dev = tri.device
    f32 = torch.float32
    t = tri.reshape(B * F, 9)
    lo, width, counts = _windows(t, S)
    ends = counts.cumsum(0)
    starts = ends - counts
    big = torch.iinfo(torch.int64).max
    key = torch.full((B * S * S,), big, dtype=torch.int64, device=dev)
    tiny = torch.full((), 1e-12, dtype=f32, device=dev)
    total = int(ends[-1].item()) if ends.numel() else 0
    a = 0
    while a < total:
        # the faces whose pairs start in [a, a + PAIRS), at least one
        f0 = int(torch.searchsorted(ends, torch.tensor(a, device=dev), right=True).item())
        f1 = max(f0 + 1, int(torch.searchsorted(starts, torch.tensor(a + PAIRS, device=dev)).item()))
        face = torch.repeat_interleave(torch.arange(f0, f1, device=dev), counts[f0:f1])
        off = torch.arange(face.numel(), device=dev) - (starts[face] - starts[f0])
        col = lo[face, 0] + off % width[face, 0]
        row = lo[face, 1] + off // width[face, 0]
        u, v = col.to(f32) + 0.5, row.to(f32) + 0.5
        c = t[face]
        ax, ay, az = c[:, 0], c[:, 1], c[:, 2]
        bx, by, bz = c[:, 3], c[:, 4], c[:, 5]
        cx, cy, cz = c[:, 6], c[:, 7], c[:, 8]
        e0 = (cx - bx) * (v - by) - (cy - by) * (u - bx)
        e1 = (ax - cx) * (v - cy) - (ay - cy) * (u - cx)
        e2 = (bx - ax) * (v - ay) - (by - ay) * (u - ax)
        area = e0 + e1 + e2
        area_ok = area.abs() > 1e-12
        area_safe = torch.where(area_ok, area, tiny)
        w0, w1, w2 = e0 / area_safe, e1 / area_safe, e2 / area_safe
        z = w0 * az + w1 * bz + w2 * cz
        # inside, and nearer than the background: z < inf (a NaN depth never wins)
        hit = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & area_ok & (z < float("inf"))
        # depths are positive, so their bits order as the floats do
        k = (z.view(torch.int32).long() << 32) | (face % F)
        pix = (face // F) * (S * S) + row * S + col
        key.scatter_reduce_(0, pix[hit], k[hit], "amin")
        a = int(ends[f1 - 1].item())
    has = key != big
    fid = torch.where(has, key & 0xFFFFFFFF, torch.full_like(key, -1)).to(torch.int32)
    zb = torch.where(has, (key >> 32).to(torch.int32).view(f32), torch.full((), float("inf"), device=dev))
    return fid.view(B, S, S), zb.view(B, S, S)


@torch.no_grad()
def select_face_id_binned(tri: torch.Tensor, image_size: int):
    """(face_id, zbuf) from the (B, F, 9) face corners, block by block of
    IMAGES images."""
    out = [_select_block(tri[b:b + IMAGES], image_size) for b in range(0, tri.shape[0], IMAGES)]
    return torch.cat([f for f, _ in out]), torch.cat([z for _, z in out])


def rasterize_face_id(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int):
    """(face_id, zbuf) at `image_size` of the screen vertices (B, V, 3)."""
    return select_face_id_binned(face_triangles(verts_screen, faces), image_size)
