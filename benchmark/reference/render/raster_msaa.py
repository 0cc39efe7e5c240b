"""K1's plain versions: multisampled (MSAA) z-buffer face selection, a
copy of the port's render/raster_msaa.py without its CUDA route.

  msaa_prep              per-face 15-float records (sign-premultiplied edge
                         coefficients, affine z-plane, face id, zmin, zmax;
                         invalid faces inert) and screen bounding boxes
  msaa_select_plain      the port's plain selection, vectorised over pixels,
                         walking the faces in ascending chunks
  msaa_select_binned     the same bits from the (pixel, face) pairs of each
                         face's box only; what the reference runs
  rasterize_msaa         the prep, then the binned selection

Outputs: face_id (B, S, S) int32 (-1 on background), coverage (B, S, S)
float32 = covered subsamples / samples^2, zbuf (B, S, S) float32 = the chosen
face's z-plane at the pixel centre clamped to [zmin, zmax] (inf on
background). The renderer recomputes its own depth and ignores zbuf.
"""

from __future__ import annotations


import numpy as np
import torch

from benchmark.reference import constant
from benchmark.reference.render.mesh import gather_face_rows

N_REC = 15  # floats per face record
_INERT = np.zeros(N_REC, np.float32)  # the record of a face that never covers
_INERT[2] = -1.0


def msaa_prep(verts_screen: torch.Tensor, faces: torch.Tensor):
    """verts_screen (B, V, 3) [u, v, z], faces (F, 3) ->
    (coef (B, F, 15) f32, bbox (B, F, 4) f32 [umin, umax, vmin, vmax]).

    Same arithmetic, in the same order, as raster_msaa._msaa_prep. A face
    with any vertex at z <= 1e-6 or |area| <= 1e-12 never covers: its record
    is all zeros with e0c = -1 and its box is empty (+inf / -inf)."""
    tri = gather_face_rows(verts_screen.detach(), faces).float()  # (B, F, 9)
    B, F, _ = tri.shape
    zok = tri[:, :, 2::3].amin(-1) > 1e-6
    ax, ay, az = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    bx, by, bz = tri[:, :, 3], tri[:, :, 4], tri[:, :, 5]
    cx, cy, cz = tri[:, :, 6], tri[:, :, 7], tri[:, :, 8]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    valid = zok & (area.abs() > 1e-12)
    one = torch.ones_like(area)
    sg = torch.where(area < 0, -one, one)
    e0u, e0v, e0c = -(cy - by) * sg, (cx - bx) * sg, ((cy - by) * bx - (cx - bx) * by) * sg
    e1u, e1v, e1c = -(ay - cy) * sg, (ax - cx) * sg, ((ay - cy) * cx - (ax - cx) * cy) * sg
    e2u, e2v, e2c = -(by - ay) * sg, (bx - ax) * sg, ((by - ay) * ax - (bx - ax) * ay) * sg
    inv = 1.0 / torch.where(valid, area.abs(), one)
    zu = (e0u * az + e1u * bz + e2u * cz) * inv
    zv = (e0v * az + e1v * bz + e2v * cz) * inv
    zc = (e0c * az + e1c * bz + e2c * cz) * inv
    fid_f = torch.arange(F, dtype=torch.float32, device=tri.device).expand(B, F)
    zmin = torch.minimum(torch.minimum(az, bz), cz)
    zmax = torch.maximum(torch.maximum(az, bz), cz)
    coef = torch.stack(
        [e0u, e0v, e0c, e1u, e1v, e1c, e2u, e2v, e2c, zu, zv, zc, fid_f, zmin, zmax], dim=-1
    )
    coef = torch.where(valid[..., None], coef, constant(_INERT, tri.device))

    inf = torch.full((), float("inf"), device=tri.device)
    fu, fv = tri[:, :, 0::3], tri[:, :, 1::3]
    ok = valid[..., None]
    bbox = torch.stack(
        [torch.where(ok, fu, inf).amin(-1), torch.where(ok, fu, -inf).amax(-1),
         torch.where(ok, fv, inf).amin(-1), torch.where(ok, fv, -inf).amax(-1)], dim=-1
    )
    return coef.contiguous(), bbox.contiguous()


# elements of one (B, S, S, chunk) temporary in the plain version
_PLAIN_CHUNK_ELEMS = 1 << 24


def msaa_select_plain(coef: torch.Tensor, image_size: int, samples: int = 3):
    """Plain PyTorch per-pixel selection from the prep's records: the same
    arithmetic as the kernel, in the same order, vectorised over pixels and
    over a chunk of faces, chunks in ascending face order."""
    B, F, _ = coef.shape
    S = image_size
    dev = coef.device
    f32 = torch.float32
    step = torch.tensor(1.0 / samples, dtype=f32, device=dev)
    half_step = 0.5 * step
    base = torch.arange(S, dtype=f32, device=dev)
    bu = base.view(1, 1, S, 1)  # pixel column -> u
    bv = base.view(1, S, 1, 1)  # pixel row -> v
    U0, V0 = bu + half_step, bv + half_step
    Uc, Vc = bu + 0.5, bv + 0.5

    zb = torch.full((B, S, S), float("inf"), dtype=f32, device=dev)
    fid = torch.full((B, S, S), -1, dtype=torch.int32, device=dev)
    covered = torch.zeros((B, S, S, samples * samples), dtype=torch.bool, device=dev)
    chunk = max(1, min(F, _PLAIN_CHUNK_ELEMS // max(1, B * S * S)))
    for f0 in range(0, F, chunk):
        c = coef[:, f0:f0 + chunk].unsqueeze(1).unsqueeze(1)  # (B, 1, 1, n, 15)
        n = c.shape[3]
        e0u, e0v, e0c = c[..., 0], c[..., 1], c[..., 2]
        e1u, e1v, e1c = c[..., 3], c[..., 4], c[..., 5]
        e2u, e2v, e2c = c[..., 6], c[..., 7], c[..., 8]
        zu, zv, zc = c[..., 9], c[..., 10], c[..., 11]
        e0r = e0u * U0 + (e0v * V0 + e0c)  # (B, S, S, n)
        e1r = e1u * U0 + (e1v * V0 + e1c)
        e2r = e2u * U0 + (e2v * V0 + e2c)
        z_c = zu * Uc + (zv * Vc + zc)
        z_c = torch.minimum(torch.maximum(z_c, c[..., 13]), c[..., 14])
        du0, du1, du2 = e0u * step, e1u * step, e2u * step
        dv0, dv1, dv2 = e0v * step, e1v * step, e2v * step

        any_bit = torch.zeros(z_c.shape, dtype=torch.bool, device=dev)
        for sy in range(samples):
            if sy:
                e0r, e1r, e2r = e0r + dv0, e1r + dv1, e2r + dv2
            c0, c1, c2 = e0r, e1r, e2r
            for sx in range(samples):
                if sx:
                    c0, c1, c2 = c0 + du0, c1 + du1, c2 + du2
                inside = torch.minimum(torch.minimum(c0, c1), c2) >= 0
                any_bit |= inside
                covered[..., sy * samples + sx] |= inside.any(-1)

        # first face (ascending) with the chunk's smallest depth; replaces the
        # running choice only when strictly nearer, as the kernel's strict <
        zm = torch.where(any_bit, z_c, torch.full_like(z_c, float("inf")))
        cmin = zm.amin(-1, keepdim=True)
        local = torch.arange(n, device=dev).expand_as(zm)
        first = torch.where(any_bit & (zm == cmin), local, n).amin(-1, keepdim=True)
        better = (cmin < zb[..., None])[..., 0]
        face = torch.gather(c[..., 12].expand(B, S, S, n), -1, first.clamp(max=n - 1))[..., 0]
        zb = torch.where(better, cmin[..., 0], zb)
        fid = torch.where(better, face.to(torch.int32), fid)

    count = covered.sum(-1, dtype=torch.int32)
    coverage = count.to(f32) / float(samples * samples)
    return fid, coverage, zb


# (pixel, face) pairs evaluated at once in the binned selection
_BINNED_PAIRS = 1 << 22


def msaa_select_binned(coef: torch.Tensor, bbox: torch.Tensor, image_size: int, samples: int = 3):
    """`msaa_select_plain`'s result, bit for bit, from the (pixel, face)
    pairs whose face box (widened by a pixel on each side) holds the pixel,
    instead of every pixel against every face: the same float32 arithmetic
    in the same order per pair, then per pixel the face of least depth, ties
    to the lowest id (the plain version's strict `<` over ascending faces),
    by an `amin` over the key (depth bits << 32 | face id); depths are
    positive, so their bits order as the floats do. Covered subsamples are
    OR-ed over every face, as in the plain version."""
    B, F, _ = coef.shape
    S = image_size
    dev = coef.device
    f32 = torch.float32
    ns = samples * samples
    step = torch.tensor(1.0 / samples, dtype=f32, device=dev)
    half_step = 0.5 * step
    valid = torch.isfinite(bbox[..., 0]).reshape(-1)
    bb = torch.where(valid[:, None], bbox.reshape(-1, 4), torch.zeros((), dtype=f32, device=dev))
    lo = (bb[:, 0::2].floor() - 1).clamp(0, S - 1).long()  # (B F, 2) first column, row
    hi = (bb[:, 1::2].floor() + 1).clamp(0, S - 1).long()
    width = hi - lo + 1
    counts = torch.where(valid, width[:, 0] * width[:, 1], torch.zeros_like(width[:, 0]))
    ends = counts.cumsum(0)
    starts = ends - counts
    big = torch.iinfo(torch.int64).max
    key = torch.full((B * S * S,), big, dtype=torch.int64, device=dev)
    covered = torch.zeros((B * S * S, ns), dtype=torch.int32, device=dev)
    coef_flat = coef.reshape(-1, coef.shape[-1])
    total = int(ends[-1].item()) if ends.numel() else 0
    a = 0
    while a < total:
        # the faces whose pairs start in [a, a + _BINNED_PAIRS), at least one
        f0 = int(torch.searchsorted(ends, torch.tensor(a, device=dev), right=True).item())
        f1 = max(f0 + 1, int(torch.searchsorted(starts, torch.tensor(a + _BINNED_PAIRS, device=dev)).item()))
        face = torch.repeat_interleave(torch.arange(f0, f1, device=dev), counts[f0:f1])
        off = torch.arange(face.numel(), device=dev) - (starts[face] - starts[f0])
        col = lo[face, 0] + off % width[face, 0]
        row = lo[face, 1] + off // width[face, 0]
        c = coef_flat[face]
        U0, V0 = col.to(f32) + half_step, row.to(f32) + half_step
        Uc, Vc = col.to(f32) + 0.5, row.to(f32) + 0.5
        e0u, e0v, e0c = c[:, 0], c[:, 1], c[:, 2]
        e1u, e1v, e1c = c[:, 3], c[:, 4], c[:, 5]
        e2u, e2v, e2c = c[:, 6], c[:, 7], c[:, 8]
        e0r = e0u * U0 + (e0v * V0 + e0c)
        e1r = e1u * U0 + (e1v * V0 + e1c)
        e2r = e2u * U0 + (e2v * V0 + e2c)
        z_c = c[:, 9] * Uc + (c[:, 10] * Vc + c[:, 11])
        z_c = torch.minimum(torch.maximum(z_c, c[:, 13]), c[:, 14])
        du0, du1, du2 = e0u * step, e1u * step, e2u * step
        dv0, dv1, dv2 = e0v * step, e1v * step, e2v * step
        bits = []
        for sy in range(samples):
            if sy:
                e0r, e1r, e2r = e0r + dv0, e1r + dv1, e2r + dv2
            c0, c1, c2 = e0r, e1r, e2r
            for sx in range(samples):
                if sx:
                    c0, c1, c2 = c0 + du0, c1 + du1, c2 + du2
                bits.append(torch.minimum(torch.minimum(c0, c1), c2) >= 0)
        inside = torch.stack(bits, dim=-1)  # (P, ns)
        pix = (face // F) * (S * S) + row * S + col
        covered.scatter_reduce_(0, pix[:, None].expand(-1, ns), inside.to(torch.int32), "amax")
        hit = inside.any(-1)
        k = (z_c.view(torch.int32).long() << 32) | c[:, 12].long()
        key.scatter_reduce_(0, pix[hit], k[hit], "amin")
        a = int(ends[f1 - 1].item())
    has = key != big
    fid = torch.where(has, key & 0xFFFFFFFF, torch.full_like(key, -1)).to(torch.int32)
    zb = torch.where(has, (key >> 32).to(torch.int32).view(f32), torch.full((), float("inf"), device=dev))
    coverage = covered.sum(-1, dtype=torch.int32).to(f32) / float(ns)
    return fid.view(B, S, S), coverage.view(B, S, S), zb.view(B, S, S)


def rasterize_msaa(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int,
                   samples: int = 3):
    """K1's plain version: (face_id, coverage, zbuf) at base resolution,
    through the binned selection (the same bits as `msaa_select_plain`)."""
    coef, bbox = msaa_prep(verts_screen, faces)
    return msaa_select_binned(coef, bbox, image_size, samples)
