"""Screen projection and K4, the supersampled (SSAA) z-buffer face selection.

Counterparts of hifihr_tpu/render/raster_jax.py (project_to_screen,
rasterize_face_id) and of the Pallas TPU kernel
hifihr_tpu/render/raster_pallas.py::_kernel (rasterize_face_id_pallas):

  rasterize_face_id_plain   plain PyTorch version, vectorised over pixels,
                            walking the faces in ascending chunks, each
                            over the pixels its faces' boxes can cover
  rasterize_face_id         the wrapper: for a CUDA tensor the route of
                            csrc/raster_face.cu (`select_face_id_cuda`,
                            three launches on the current stream: a zero
                            fill of per-bin face bitmasks, a bin kernel that
                            sets each face's bit in every 32x32 bin its box
                            overlaps, and a fine kernel that walks each
                            16x16 tile's faces in ascending order); for a CPU
                            tensor the plain version

Screen convention: pixel coordinates, u right / v down, pixel centres at
i + 0.5; u = fx * x / z + cx (OpenCV-style K).

K4's contract, at every pixel centre (u, v) = (col + 0.5, row + 0.5):
  e0 = (cx - bx) (v - by) - (cy - by) (u - bx), e1 and e2 cyclically (not
  sign-normalised, so both windings count); area = (e0 + e1) + e2 per pixel;
  w = e / where(|area| > 1e-12, area, 1e-12) (IEEE division); inside when
  all three w >= 0 and |area| > 1e-12; z = (w0 az + w1 bz) + w2 cz. A face
  with any vertex at z <= 1e-6 never counts. The nearest inside face wins,
  strict < in ascending face order, so the lowest id wins a tie. Outputs:
  face_id (B, S, S) int32 (-1 on background) and zbuf (B, S, S) float32
  (inf on background). No gradient.

Launch counts (utils/profiling.py's `counters`): `rasterize_face_id.launches`
counts routes (one per call on a CUDA tensor);
`rasterize_face_id.device_launches` counts the route's launches (3 per route
with F > 0), each counted by the C route where it enqueues it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hifihr_tpu_torch import kernels
from hifihr_tpu_torch.render.mesh import gather_face_rows
from hifihr_tpu_torch.utils import profiling


def project_to_screen(verts_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """verts_cam (B, V, 3), K (B, 3, 3) pixel intrinsics -> (B, V, 3) [u, v, z]."""
    z = verts_cam[..., 2:3]
    z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    u = K[:, None, 0, 0:1] * verts_cam[..., 0:1] / z_safe + K[:, None, 0, 2:3]
    v = K[:, None, 1, 1:2] * verts_cam[..., 1:2] / z_safe + K[:, None, 1, 2:3]
    return torch.cat([u, v, z], dim=-1)


def face_triangles(verts_screen: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """K4's input: (B, F, 9) fp32 rows [a_uvz b_uvz c_uvz], no gradient."""
    return gather_face_rows(verts_screen.detach(), faces).float().contiguous()


# elements of one (B, S, S, chunk) temporary in the plain version
_PLAIN_CHUNK_ELEMS = 1 << 24


def _chunk_window(tc: torch.Tensor, S: int):
    """(r0, r1, c0, c1): the rows and columns whose pixel centres can lie
    inside a valid face of the chunk tc (B, n, 9), one pixel wider on each
    side than its faces' boxes (a centre outside a face's box is outside the
    face, whatever the rounding), clipped to the image; None when no face
    of the chunk is valid or the window is empty."""
    valid = (tc[..., 2::3] > 1e-6).all(-1)
    if not bool(valid.any()):
        return None
    us, vs = tc[..., 0::3][valid], tc[..., 1::3][valid]
    bounds = [float(x) for x in (us.min(), us.max(), vs.min(), vs.max())]
    if not all(math.isfinite(x) for x in bounds):
        return 0, S, 0, S
    lo_u, hi_u, lo_v, hi_v = bounds
    c0, c1 = max(0, math.floor(lo_u - 0.5) - 1), min(S, math.floor(hi_u - 0.5) + 2)
    r0, r1 = max(0, math.floor(lo_v - 0.5) - 1), min(S, math.floor(hi_v - 0.5) + 2)
    return (r0, r1, c0, c1) if r0 < r1 and c0 < c1 else None


def select_face_id_plain(tri: torch.Tensor, image_size: int):
    """Plain PyTorch selection from K4's (B, F, 9) input: the kernel's
    arithmetic in the same order, vectorised over pixels and a chunk of
    faces, chunks in ascending face order, each over the window of pixels
    its faces can cover (`_chunk_window`)."""
    B, F, _ = tri.shape
    S = image_size
    dev = tri.device
    f32 = torch.float32
    centre = torch.arange(S, dtype=f32, device=dev) + 0.5
    u_all = centre.view(1, 1, S, 1)  # pixel column
    v_all = centre.view(1, S, 1, 1)  # pixel row

    zb = torch.full((B, S, S), float("inf"), dtype=f32, device=dev)
    fid = torch.full((B, S, S), -1, dtype=torch.int32, device=dev)
    tiny = torch.full((), 1e-12, dtype=f32, device=dev)
    chunk = max(1, min(F, _PLAIN_CHUNK_ELEMS // max(1, B * S * S)))
    for f0 in range(0, F, chunk):
        window = _chunk_window(tri[:, f0:f0 + chunk], S)
        if window is None:
            continue
        r0, r1, c0, c1 = window
        u, v = u_all[:, :, c0:c1], v_all[:, r0:r1]
        t = tri[:, f0:f0 + chunk].unsqueeze(1).unsqueeze(1)  # (B, 1, 1, n, 9)
        n = t.shape[3]
        ax, ay, az = t[..., 0], t[..., 1], t[..., 2]
        bx, by, bz = t[..., 3], t[..., 4], t[..., 5]
        cx, cy, cz = t[..., 6], t[..., 7], t[..., 8]
        e0 = (cx - bx) * (v - by) - (cy - by) * (u - bx)  # (B, rows, cols, n)
        e1 = (ax - cx) * (v - cy) - (ay - cy) * (u - cx)
        e2 = (bx - ax) * (v - ay) - (by - ay) * (u - ax)
        area = e0 + e1 + e2
        area_ok = area.abs() > 1e-12
        area_safe = torch.where(area_ok, area, tiny)
        w0, w1, w2 = e0 / area_safe, e1 / area_safe, e2 / area_safe
        zvalid = torch.minimum(torch.minimum(az, bz), cz) > 1e-6
        hit = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & area_ok & zvalid
        z = w0 * az + w1 * bz + w2 * cz

        # first face (ascending) with the chunk's smallest depth; replaces the
        # running choice only when strictly nearer, as the kernel's strict <
        zm = torch.where(hit, z, torch.full_like(z, float("inf")))
        cmin = zm.amin(-1, keepdim=True)
        local = torch.arange(n, device=dev).expand_as(zm)
        first = torch.where(hit & (zm == cmin), local, n).amin(-1)
        zb_w, fid_w = zb[:, r0:r1, c0:c1], fid[:, r0:r1, c0:c1]
        better = cmin[..., 0] < zb_w
        zb[:, r0:r1, c0:c1] = torch.where(better, cmin[..., 0], zb_w)
        fid[:, r0:r1, c0:c1] = torch.where(better, (first + f0).to(torch.int32), fid_w)
    return fid, zb


def rasterize_face_id_plain(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int):
    """Plain PyTorch version of K4: (face_id, zbuf)."""
    return select_face_id_plain(face_triangles(verts_screen, faces), image_size)


def select_face_id_cuda(tri: torch.Tensor, image_size: int):
    """Launch the route of csrc/raster_face.cu on K4's (B, F, 9) input: zero
    fill of the bin bitmasks (sized by the C side, `hifihr_face_mask_words`),
    bin kernel, fine kernel. Counts the route on the counter
    `rasterize_face_id.launches` and adds the launches the C route counted
    as it enqueued them to `rasterize_face_id.device_launches`."""
    B, F, _ = tri.shape
    S = image_size
    if tri.device.type != "cuda":
        raise ValueError("select_face_id_cuda needs a CUDA tensor")
    if tri.dtype != torch.float32 or tri.shape != (B, F, 9) or not tri.is_contiguous():
        raise ValueError(f"tri must be a contiguous float32 (B, F, 9) tensor, got "
                         f"{tri.dtype} {tuple(tri.shape)}")
    if B > 65535 or B * S * S >= 2**31 or F >= 2**24:
        raise ValueError(f"B={B}, F={F}, S={S} outside the kernel's range")
    lib = kernels.load("raster_face")
    mask = torch.empty(lib.hifihr_face_mask_words(B, F, S), dtype=torch.int32, device=tri.device)
    fid = torch.empty((B, S, S), dtype=torch.int32, device=tri.device)
    zbuf = torch.empty((B, S, S), dtype=torch.float32, device=tri.device)
    launched = ctypes.c_int(0)
    err = lib.hifihr_face_route(tri.data_ptr(), B, F, S, mask.data_ptr(), fid.data_ptr(),
                                zbuf.data_ptr(), kernels.stream_ptr(tri.device), ctypes.byref(launched))
    profiling.counters["rasterize_face_id.device_launches"] += launched.value
    kernels.check(err, "raster_face")
    if B and S:
        profiling.counters["rasterize_face_id.launches"] += 1
    return fid, zbuf


def rasterize_face_id(verts_screen: torch.Tensor, faces: torch.Tensor, image_size: int):
    """K4: (face_id, zbuf) at `image_size`. A CUDA tensor goes through the
    CUDA kernel (or raises); a CPU tensor through the plain version."""
    if verts_screen.device.type == "cpu":
        return rasterize_face_id_plain(verts_screen, faces, image_size)
    if verts_screen.device.type != "cuda":
        raise ValueError(f"rasterize_face_id: unsupported device {verts_screen.device}")
    return select_face_id_cuda(face_triangles(verts_screen, faces), image_size)
