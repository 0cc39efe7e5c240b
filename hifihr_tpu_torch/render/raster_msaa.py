"""K1: multisampled (MSAA) z-buffer face selection.

Counterpart of hifihr_tpu/render/raster_msaa.py (the Pallas TPU kernel
`_kernel` and its XLA prep `_msaa_prep`). Three parts:

  msaa_prep              torch prep shared by both versions: per-face
                         15-float records (sign-premultiplied edge
                         coefficients, affine z-plane, face id, zmin, zmax;
                         invalid faces inert) and screen bounding boxes
  rasterize_msaa_plain   plain PyTorch version, vectorised over pixels,
                         walking the faces in ascending chunks
  rasterize_msaa         the wrapper: for a CUDA tensor, the prep and then
                         the route of csrc/raster_msaa.cu (`msaa_select_cuda`,
                         three launches on the current stream: a zero fill of
                         per-tile face bitmasks, a bin kernel that sets each
                         face's bit in every 16x16 tile its box overlaps, and
                         a fine kernel that walks each tile's faces in
                         ascending order); for a CPU tensor the plain version

Outputs: face_id (B, S, S) int32 (-1 on background), coverage (B, S, S)
float32 = covered subsamples / samples^2, zbuf (B, S, S) float32 = the chosen
face's z-plane at the pixel centre clamped to [zmin, zmax] (inf on
background). The renderer recomputes its own depth and ignores zbuf.

Launch counts: `rasterize_msaa.launches` counts routes (one per call on a
CUDA tensor); `rasterize_msaa.device_launches` counts the route's launches
(3 per route with F > 0), each counted by the C route where it enqueues it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hifihr_tpu_torch import constant, kernels
from hifihr_tpu_torch.render.mesh import gather_face_rows

N_REC = 15  # floats per face record
TILE = 16  # pixels per side of a tile of the CUDA route
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


def rasterize_msaa_plain(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int,
                         samples: int = 3):
    """Plain PyTorch version of K1: (face_id, coverage, zbuf)."""
    coef, _ = msaa_prep(verts_screen, faces)
    return msaa_select_plain(coef, image_size, samples)


def msaa_select_cuda(coef: torch.Tensor, bbox: torch.Tensor, image_size: int,
                     samples: int = 3):
    """Launch the route of csrc/raster_msaa.cu on the prep's records: zero
    fill of the (B, T, T, ceil(F / 32)) tile bitmasks (T = ceil(S / 16)),
    bin kernel, fine kernel. Counts the route on `rasterize_msaa.launches`
    and adds the launches the C route counted as it enqueued them to
    `rasterize_msaa.device_launches`."""
    B, F, _ = coef.shape
    S = image_size
    if coef.device.type != "cuda" or bbox.device != coef.device:
        raise ValueError("msaa_select_cuda needs coef and bbox on one CUDA device")
    if coef.dtype != torch.float32 or bbox.dtype != torch.float32:
        raise TypeError("coef and bbox must be float32")
    if coef.shape != (B, F, N_REC) or bbox.shape != (B, F, 4):
        raise ValueError(f"bad shapes coef {tuple(coef.shape)} bbox {tuple(bbox.shape)}")
    if not (coef.is_contiguous() and bbox.is_contiguous()):
        raise ValueError("coef and bbox must be contiguous")
    if bbox.data_ptr() % 16:
        raise ValueError("bbox must be 16-byte aligned (read as float4)")
    if not 1 <= samples * samples <= 32 or B > 65535:
        raise ValueError(f"samples={samples}, B={B} outside the kernel's range")
    lib = kernels.load("raster_msaa")
    tiles = -(-S // TILE)
    mask = torch.empty((B, tiles, tiles, -(-F // 32)), dtype=torch.int32, device=coef.device)
    fid = torch.empty((B, S, S), dtype=torch.int32, device=coef.device)
    cov = torch.empty((B, S, S), dtype=torch.float32, device=coef.device)
    zbuf = torch.empty((B, S, S), dtype=torch.float32, device=coef.device)
    launched = ctypes.c_int(0)
    err = lib.hifihr_msaa_raster(
        coef.data_ptr(), bbox.data_ptr(), B, F, S, samples, mask.data_ptr(),
        fid.data_ptr(), cov.data_ptr(), zbuf.data_ptr(), kernels.stream_ptr(coef.device),
        ctypes.byref(launched))
    rasterize_msaa.device_launches += launched.value
    kernels.check(err, "raster_msaa")
    if B and S:
        rasterize_msaa.launches += 1
    return fid, cov, zbuf


def rasterize_msaa(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int,
                   samples: int = 3):
    """K1: (face_id, coverage, zbuf) at base resolution. A CUDA tensor goes
    through the CUDA kernel (or raises); a CPU tensor through the plain
    version."""
    if verts_screen.device.type == "cpu":
        return rasterize_msaa_plain(verts_screen, faces, image_size, samples)
    if verts_screen.device.type != "cuda":
        raise ValueError(f"rasterize_msaa: unsupported device {verts_screen.device}")
    coef, bbox = msaa_prep(verts_screen, faces)
    return msaa_select_cuda(coef, bbox, image_size, samples)


rasterize_msaa.launches = 0
rasterize_msaa.device_launches = 0
