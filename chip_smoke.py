"""Drive the PyTorch port (hifihr_tpu_torch) on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py` (one CUDA card, nvcc
under /usr/local/cuda or on PATH). `--profile` adds a torch.profiler pass
over a few eval steps and a few train steps of both render modes. Phases:

  1. the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels from hifihr_tpu_torch/csrc/ into
     build/hifihr_tpu_torch/ (one nvcc per source, in parallel)
  3. K1 (MSAA face selection: a zero fill, a bin kernel and a fine kernel)
     against its plain PyTorch version on 64 posed MANO meshes at 224^2,
     on a crafted 64^2 scene of tile-bin edge cases (`bin_edge_scene`) and
     on K4's crafted scene: face_id, coverage and zbuf exactly equal; the
     route's time, each launch's device time (torch.profiler), the pairs it
     walks and its bound
  4. K2 (per-pixel row gather) against its plain version on the table and
     face ids of phase 3, (64, 1538, 27) x (64, 50176): bit-equal
  5. K3 (the scatter-add backward of K2) against its plain version on the
     render's real backward input: the (64, 50176, 27) gradient that an L1
     loss on the shaded phase-3 render sends to K2's output, and K1's face
     ids. fp32 sums in varying order on both sides, and fp32 atomics that
     flush subnormals to zero, so each entry summed from n rows is held
     within 2 ((n - 1) 2^-24 sum|g| + n 2^-126) of the other
  6. the flagship eval step (ResNet-50 + MANO + MSAA render, batch 64,
     224^2, bf16 encoder, seeded random weights): K1 and K2 launched, the
     outputs finite and the silhouette non-empty; the same step in fp32 on
     the card against the plain versions on the CPU on two images; the
     median step time and images/s over 15 steps (CUDA events)
  7. the flagship train step (the same model and batch, the bench losses,
     backward through the render, Adam): K1 (each of its three launches),
     K2 and K3 launched, the 15 loss terms and the total finite and the
     step not skipped, the parameters changed, a 10-step loss trajectory,
     one step under torch.cuda.set_sync_debug_mode("error") (no host sync),
     the fp32 step on the card against the plain versions on the CPU in the
     train-slice test's configuration (res18, 32 px, 8 images; loss terms
     within 1e-4, each gradient within 1e-3 relative L2), the median step
     time and images/s over 15 steps, and the peak memory; then K1 and K3
     on the step's own inputs, captured at its first step (the seeded
     init's hand) and at a step after the timed ones (the hand the updates
     have grown): K1 exactly equal to its plain version and K3 within its
     atomics bound, with coverage, rows of the largest face, pairs, time,
     each launch's time and bound
  8. K4 (SSAA face selection) against its plain version on the first 8
     meshes of phase 3 projected at K * 3 to 672^2, and on a crafted 64^2
     scene (a vertex at z <= 1e-6, a zero-area face, both windings, two
     identical faces): face_id and zbuf exactly equal; and the SSAA
     per-pixel corner fetch forward and backward through K2 and K3 (the
     port's route) beside torch's advanced indexing (JAX's form)
  9. the SSAA eval step (the flagship with aa_mode="ssaa", batch 8, the
     cell of bench.py:276-278): K4 launched once per step, the outputs
     finite and the silhouette non-empty, the median step time and images/s
     over 15 steps; the fp32 SSAA eval step on the card against the CPU in
     the train-slice test's configuration (res18, 32 px, 8 images)
 10. the SSAA train step (the same model and batch of 8): the checks of
     phase 7, with K4, K2 and K3 launched, the card-against-CPU step in the
     train-slice test's configuration with aa_mode="ssaa", and K3 on each of
     the step's two launches at both captured steps
 11. one `{"kernels": [...]}` line: per kernel its time (K1 the whole route,
     its launches' device times under `parts_ms`), launches in one step of
     its path (K1 routes and K2 the eval step, K3 the train step, K4 the
     SSAA eval step; the train step of each path under
     `launches_train_step`, and every kernel's count in the SSAA steps under
     `launches_ssaa_eval_step` and `launches_ssaa_train_step`), error
     against the plain version, the plain version's time, the bound and,
     for K2 and K3, one PyTorch call's time (indexing; `index_add_`); K1
     and K3 carry their numbers on the train steps' inputs under
     `train_hand`

Any failed check raises, so the exit code is nonzero; so it is without CUDA.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

B, S = 64, 224
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 rate outside the tensor cores
K1_OPS_PER_PAIR = 60  # 9 subsamples x (3 edge steps + 2 min + 1 compare) + depth plane
# 15 for the edges, 2 area adds, |area| test, 3 divisions, 3 sign tests,
# 5 for the depth, 1 depth test (csrc/raster_face.cu's inner loop)
K4_OPS_PER_PAIR = 30
SSAA_B, AA = 8, 3  # the SSAA cell: bench.py:278 times it at batch 8
STEPS = 15
# the bench losses (bench.py:46-49); texture_con and segms_gt in the batch
# add both photometric triples
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "iou", "bone_direc")
FIRED = LOSSES + ("texture_self", "mrgb_self", "ssim_tex_self", "texture", "mrgb", "ssim_tex", "total")
# the configuration of tests/test_torch_train_slice.py
SLICE_CFG = dict(pretrain="res18", hand_model="mano", render=True, light_estimation=False, image_size=32,
                 aa_factor=3, aa_mode="msaa", compute_dtype="float32", losses=LOSSES)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, reps: int, groups: int = 3) -> float:
    """Median over `groups` of the mean time of `reps` back-to-back calls,
    from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def flagship_batch(device) -> dict:
    """__graft_entry__._fake_batch(64, 224) plus the seeded noise of
    bench.py:72-76."""
    f = S * 1.8
    K = np.asarray([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
    imgs = np.random.RandomState(0).rand(B, S, S, 3).astype(np.float32)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    return {
        "imgs": torch.tensor(imgs, device=device),
        "Ks": torch.tensor(np.tile(K[None], (B, 1, 1)), device=device),
        "root_xyz": torch.tensor([[[0.0, 0.0, 0.5]]], device=device).repeat(B, 1, 1),
        "joints": zeros(B, 21, 3), "j2d_gt": zeros(B, 21, 2), "verts": zeros(B, 778, 3),
        "segms_gt": zeros(B, S, S), "texture_con": torch.ones(B, device=device),
        "scales": torch.full((B,), 0.0282, device=device),
    }


def posed_meshes(batch: dict, seed: int = 1):
    """64 posed MANO meshes (numpy-seeded pose and shape) placed as the model
    places them, with the model's vertex albedo and normals: the inputs K1
    and K2 get on the main path. Returns (camera-space verts, their screen
    projection, faces, [albedo | normals])."""
    from hifihr_tpu_torch.hand.mano import ManoLayer
    from hifihr_tpu_torch.render.mesh import vertex_normals
    from hifihr_tpu_torch.render.raster import project_to_screen
    from hifihr_tpu_torch.render.renderer import PhongRenderer

    dev = batch["Ks"].device
    rng = np.random.RandomState(seed)
    mano = ManoLayer(ncomps=45).to(dev)
    pose = torch.tensor(rng.randn(B, 48) * 0.3, dtype=torch.float32, device=dev)
    beta = torch.tensor(rng.randn(B, 10) * 0.5, dtype=torch.float32, device=dev)
    verts = mano(pose, beta).verts + batch["root_xyz"]
    faces = PhongRenderer(mano.faces_np, mano.v_template_np).faces.to(dev)
    vs = project_to_screen(verts, batch["Ks"])
    albedo = torch.sigmoid(torch.tensor([1.0, 0.2, -0.2], device=dev)).expand(B, 778, 3)
    attrs = torch.cat([albedo, vertex_normals(verts, faces)], dim=-1)
    return verts, vs, faces, attrs


def box_pairs(bbox: torch.Tensor, size: int, cell: tuple = (1, 1)) -> int:
    """(cell, face) pairs whose face box touches the cell, for cells of
    cell[0] x cell[1] pixels (u, v) over a size^2 image. With 1 x 1 cells,
    the (pixel, face) pairs: the work K1 or K4 needs for these inputs,
    however it culls. bbox (B, F, 4) [umin, umax, vmin, vmax], inf for a
    face that never counts."""
    valid = torch.isfinite(bbox[..., 0])
    bb = torch.where(valid[..., None], bbox, torch.zeros_like(bbox))
    (cu, cv), counts = cell, []
    for lo, hi, c in ((bb[..., 0], bb[..., 1], cu), (bb[..., 2], bb[..., 3], cv)):
        n = -(-size // c)
        counts.append(((hi / c).floor().clamp(0, n - 1) - (lo / c).floor().clamp(0, n - 1) + 1,
                       (hi >= 0) & (lo < n * c)))
    n = counts[0][0] * counts[1][0]
    return int(torch.where(valid & counts[0][1] & counts[1][1], n, torch.zeros_like(n)).sum().item())


def tile_pairs(bbox: torch.Tensor, size: int, tile: int = 16) -> int:
    """(pixel, listed face) pairs a tile-culling rasteriser walks: each face
    is listed by every tile its box touches, and all the tile's pixels test
    it (K4, and K1 before its warp culling)."""
    return box_pairs(bbox, size, (tile, tile)) * tile * tile


def walked_pairs(bbox: torch.Tensor, size: int) -> int:
    """(pixel, tested face) pairs K1's fine kernel walks: a warp tests a
    listed face at its 32 pixels when the face's box touches the warp's
    16 x 2 pixel footprint."""
    return box_pairs(bbox, size, (16, 2)) * 32


def bin_edge_scene():
    """A 64^2 screen-space scene for K1's binning into 16 px tiles, as numpy
    (verts (2, V, 3) [u, v, z], faces (F, 3)): boxes that end exactly on a
    tile edge and just inside one, slivers, a face over four tiles, a face
    off the screen's edge, two identical faces (9 wins the tie) and an edge
    through a column of subsamples. Image 1 mirrors image 0 in u, so its
    faces wind the other way and its box edges still lie on tile edges."""
    tris = [
        [(4, 4, .5), (16, 4, .5), (16, 14, .5)],            # 0: right edge on the tile edge u = 16
        [(17, 18, .6), (31.99, 20, .6), (31.99, 30, .6)],   # 1: right edge just inside u = 32
        [(36, 20, .5), (46, 32, .5), (38, 32, .5)],         # 2: bottom edge on the tile edge v = 32
        [(48, 4, .5), (60, 4, .5), (48, 14, .5)],           # 3: left edge on the tile edge u = 48
        [(47.99, 36, .5), (60, 38, .5), (50, 46, .5)],      # 4: a corner just inside u = 48
        [(20, 4, .5), (30, 16, .5), (20, 16, .5)],          # 5: bottom edge on the tile edge v = 16
        [(2, 40, .4), (62, 41, .4), (62, 41.05, .4)],       # 6: a thin sliver across four tiles
        [(33.45, 2, .4), (33.55, 2, .4), (33.55, 62, .4)],  # 7: a 0.1 px sliver down four tiles
        [(24, 24, .3), (40, 26, .45), (30.3, 39.7, .6)],    # 8: a face over four tiles
        [(50, 50, .5), (62, 52, .5), (54, 62, .5)],         # 9 and 10: the same face
        [(50, 50, .5), (62, 52, .5), (54, 62, .5)],
        [(5.5, 50, .5), (12, 50, .5), (5.5, 60, .5)],       # 11: an edge through subsamples
        [(-6, 56, .45), (6, 58, .45), (-2, 70, .45)],       # 12: over the screen's edge
    ]
    v = np.asarray(tris, np.float32).reshape(1, -1, 3)
    mirror = v.copy()
    mirror[..., 0] = 64.0 - mirror[..., 0]
    return np.concatenate([v, mirror]), np.arange(v.shape[1], dtype=np.int32).reshape(-1, 3)


def device_ms(fn, reps: int = 20) -> dict:
    """Mean device time of one launch of each kernel or memset `fn` makes,
    by name, from torch.profiler over `reps` calls after one warm-up call
    and one traced but not counted: {name: (ms per launch, launches seen)}.
    The profiler can miss launches (one profile on an H100 saw 2.3 of K1's
    3 per route), so the mean is over the launches it saw, and no count is
    read from it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps, repeat=1)) as prof:
        for _ in range(reps + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return {e.key: (e.self_device_time_total / e.count / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")}  # the schedule's step annotations


K1_PARTS = ("zero_fill", "bin", "fine")  # K1's route, one launch each


def k1_launches_per_route(fn) -> int:
    """The launches one call of `fn` makes in K1's route, as the C route
    counts them where it enqueues each one."""
    from hifihr_tpu_torch.render import raster_msaa as k1

    before = k1.rasterize_msaa.device_launches, k1.rasterize_msaa.launches
    fn()
    routes = k1.rasterize_msaa.launches - before[1]
    check(routes == 1, f"one K1 route per call ({routes})")
    return k1.rasterize_msaa.device_launches - before[0]


def k1_route(coef: torch.Tensor, bbox: torch.Tensor, what: str, size: int = S) -> dict:
    """K1's route against its plain version on the prep's records (face_id,
    coverage and zbuf exactly equal), then its time, the launches of one
    route as the C route counts them (a zero fill, the bin kernel and the
    fine kernel: 3), each launch's device time (torch.profiler), the pairs
    it walks and its bound."""
    from hifihr_tpu_torch.render import raster_msaa as k1

    fid, cov, zb = k1.msaa_select_cuda(coef, bbox, size)
    fid_p, cov_p, zb_p = k1.msaa_select_plain(coef, size)
    torch.cuda.synchronize()
    for name, a, b in (("face_id", fid, fid_p), ("coverage", cov, cov_p), ("zbuf", zb, zb_p)):
        check(torch.equal(a, b), f"K1 {name} equals the plain version on {what} "
                                 f"({(a != b).sum().item()} mismatches)")
    covered = (fid_p >= 0).float().mean().item()
    check(covered > 0.01, f"K1 scene covers pixels on {what}")
    route = lambda: k1.msaa_select_cuda(coef, bbox, size)  # noqa: E731
    per_route = k1_launches_per_route(route)
    check(per_route == len(K1_PARTS), f"K1's route is a zero fill, a bin and a fine launch on {what}: "
                                      f"{per_route} launches")
    ms = time_ms(route, reps=20)
    for _ in range(3):  # a profile that missed every launch of one part is taken again
        parts = {}
        for name, (t, _) in device_ms(route).items():
            part = "bin" if "bin" in name else "fine" if "fine" in name else "zero_fill" if "emset" in name else name
            parts[part] = parts.get(part, 0.0) + t
        if set(parts) == set(K1_PARTS):
            break
    check(set(parts) == set(K1_PARTS), f"the profiler saw K1's three launches on {what}: {sorted(parts)}")
    pairs = box_pairs(bbox, size)
    nbytes = (coef.numel() + bbox.numel()) * 4 + 3 * fid.numel() * 4
    bound_ms, bound_by = bound(nbytes, pairs * K1_OPS_PER_PAIR)
    out = {"hand": what, "shape": list(coef.shape), "covered": covered, "box_pairs": pairs,
           "walked_pairs": walked_pairs(bbox, size), "tile_pairs": tile_pairs(bbox, size),
           "route_ms": ms, "parts_ms": parts, "launches_per_route": per_route,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"K1 on {what}: " + json.dumps(out))
    return out


def k3_launch(g: torch.Tensor, idx: torch.Tensor, n_rows: int, what: str) -> dict:
    """K3 against its plain version on one input (within the atomics bound:
    both sides sum in fp32 in varying order, and an entry of n rows lies
    within (n - 1) 2^-24 sum|g| of the exact sum; fp32 atomics on the card
    also flush subnormal operands and results to zero, which moves a sum by
    less than 2^-126 per addition, n 2^-126 in all; so the two lie within
    twice the sum of those). On long runs that bound is loose, so K3 also
    sums ones at every element: fp32 adds of 1.0 are exact below 2^24, so
    each entry must equal its face's row count, and a row dropped or added
    twice shows. Then its time and bound."""
    from hifihr_tpu_torch.render import gather

    d3 = gather.scatter_rows(g, idx, n_rows)
    ref = gather.scatter_rows_plain(g, idx, n_rows)
    rows = gather.scatter_rows_plain(torch.ones_like(g[..., :1]), idx, n_rows)
    counted = gather.scatter_rows(torch.ones_like(g), idx, n_rows)
    abs_sum = gather.scatter_rows_plain(g.abs(), idx, n_rows)
    torch.cuda.synchronize()
    check(torch.equal(counted, rows.expand_as(counted)),
          f"K3 sums of ones equal the row counts exactly on {what} "
          f"({(counted != rows).sum().item()} entries differ)")
    tol = 2.0 * ((rows - 1).clamp(min=0) * 2.0**-24 * abs_sum + rows * 2.0**-126)
    err = (d3 - ref).abs().max().item()
    check(tuple(d3.shape) == (g.shape[0], n_rows, g.shape[2]), f"K3 shape {tuple(d3.shape)} on {what}")
    check(bool(((d3 - ref).abs() <= tol).all()), f"K3 within the atomics bound of the plain version on {what} ({err})")
    check(g.abs().sum().item() > 0 and d3.abs().sum().item() > 0, f"K3 input and output non-zero on {what}")
    covered = int(((idx >= 0) & (idx < n_rows)).sum().item())
    # the bytes the work needs: idx, the rows of covered pixels, the output
    bound_ms, bound_by = bound(idx.numel() * 4 + covered * g.shape[2] * 4 + d3.numel() * 4, covered * g.shape[2])
    out = {"input": what, "shape": list(g.shape), "covered_rows": covered, "covered_share": covered / idx.numel(),
           "largest_face_rows": int(rows.max().item()), "max_abs_err": err,
           "ms": time_ms(lambda: gather.scatter_rows(g, idx, n_rows), reps=50),
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"K3 on {what}: " + json.dumps(out))
    return out


@contextlib.contextmanager
def captured_kernel_inputs():
    """Record the inputs of every K1 route (coef, bbox, size) and every K3
    launch (values, idx, n_rows) the port makes inside the block, by
    wrapping the module functions its wrappers call; the kernels still
    run, and their counts are untouched."""
    from hifihr_tpu_torch.render import gather, raster_msaa

    got = {"K1": [], "K3": []}
    k1_fn, k3_fn = raster_msaa.msaa_select_cuda, gather._scatter

    def k1(coef, bbox, image_size, samples=3):
        got["K1"].append((coef.clone(), bbox.clone(), image_size))
        return k1_fn(coef, bbox, image_size, samples)

    def k3(values, idx, n_rows):
        got["K3"].append((values.detach().clone(), idx.clone(), n_rows))
        return k3_fn(values, idx, n_rows)

    raster_msaa.msaa_select_cuda, gather._scatter = k1, k3
    try:
        yield got
    finally:
        raster_msaa.msaa_select_cuda, gather._scatter = k1_fn, k3_fn


def bound(nbytes: int, ops: int = 0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def l1_render_grad(batch: dict, fid: torch.Tensor, cov: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The gradient that an L1 loss on the shaded render sends to K2's
    output `rows` (B, S * S, 27): K3's input on the MSAA path."""
    from hifihr_tpu_torch.render.interpolate import interpolate_rows
    from hifihr_tpu_torch.render.renderer import _pixel_ray_points
    from hifihr_tpu_torch.render.shading import DirectionalLight, phong_shade

    n = rows.shape[0]
    pix = rows.detach().requires_grad_()
    attrs_px, mask, zbuf = interpolate_rows(fid, pix.reshape(n, S, S, rows.shape[2]))
    points = _pixel_ray_points(zbuf, mask, batch["Ks"], S)
    rgb = phong_shade(attrs_px[..., :3], attrs_px[..., 3:6], points,
                      DirectionalLight.default(n, device=pix.device)) * cov[..., None]
    return torch.autograd.grad((rgb - batch["imgs"]).abs().mean(), pix)[0].contiguous()


def phase_kernels(batch: dict) -> list:
    from hifihr_tpu_torch.render import gather as k2
    from hifihr_tpu_torch.render import raster_msaa as k1
    from hifihr_tpu_torch.render.interpolate import pack_face_table

    _, vs, faces, attrs = posed_meshes(batch)
    fid, cov, zb = k1.rasterize_msaa(vs, faces, S)
    fid_p, cov_p, zb_p = k1.rasterize_msaa_plain(vs, faces, S)
    torch.cuda.synchronize()
    covered = fid_p >= 0
    print(f"K1: covered pixels {covered.float().mean().item():.4f}, "
          f"face_id mismatches {(fid != fid_p).sum().item()}, "
          f"coverage mismatches {(cov != cov_p).sum().item()}")
    check(torch.equal(fid, fid_p), "K1 face_id equals the plain version")
    check(torch.equal(cov, cov_p), "K1 coverage equals the plain version")
    check(torch.equal(zb, zb_p), "K1 zbuf equals the plain version")
    check(covered.float().mean().item() > 0.01, "K1 scene covers pixels")
    k1_err = max((cov - cov_p).abs().max().item(), (zb[covered] - zb_p[covered]).abs().max().item())
    # the crafted scenes: K1's tile binning, and K4's edge cases
    edge_vs, edge_faces = bin_edge_scene()
    cvs, cfaces = crafted_scene(vs.device)
    for what, sv, sf, won in (
            ("the bin-edge scene", torch.tensor(edge_vs, device=vs.device),
             torch.tensor(edge_faces, device=vs.device).long(), set(range(-1, 13)) - {10}),
            ("K4's crafted scene", cvs, cfaces, {-1, 2, 3, 4})):
        got = k1.rasterize_msaa(sv, sf, 64)
        ref = k1.rasterize_msaa_plain(sv, sf, 64)
        torch.cuda.synchronize()
        seen = set(torch.unique(got[0]).tolist())
        print(f"K1 on {what} (64^2): faces selected {sorted(seen)}")
        check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"K1 equals the plain version on {what}")
        check(seen == won, f"K1 on {what}: the faces that win are {sorted(won)}, not {sorted(seen)}")

    table = pack_face_table(vs, faces, attrs)
    idx = fid.reshape(B, S * S).contiguous()
    out = k2.gather_rows(table, idx)
    ref = k2.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    check(tuple(table.shape) == (B, 1538, 27) and tuple(idx.shape) == (B, S * S),
          f"K2 shapes {tuple(table.shape)} x {tuple(idx.shape)}")
    check(torch.equal(out.view(torch.int32), ref.view(torch.int32)), "K2 bit-equal to the plain version")
    k2_err = (out - ref).abs().max().item()
    print(f"K2: bit-equal, {(idx >= 0).float().mean().item():.4f} of rows fetched")

    coef, bbox = k1.msaa_prep(vs, faces)  # K1's inputs, timed apart from the route
    k1_eval = k1_route(coef, bbox, "the eval hand")
    k1_plain_ms = time_ms(lambda: k1.msaa_select_plain(coef, S), reps=1, groups=2)
    prep_ms = time_ms(lambda: k1.msaa_prep(vs, faces), reps=20)
    print(f"K1: route {k1_eval['route_ms']:.4f} ms, plain {k1_plain_ms:.2f} ms, shared prep {prep_ms:.4f} ms")

    b_idx = torch.arange(B, device=idx.device)[:, None]
    k2_ms = time_ms(lambda: k2.gather_rows(table, idx), reps=50)
    k2_plain_ms = time_ms(lambda: k2.gather_rows_plain(table, idx), reps=20)
    lib_ms = time_ms(lambda: table[b_idx, idx.clamp(min=0).long()] * (idx >= 0)[..., None], reps=20)
    k2_bound, k2_by = bound(table.numel() * 4 + idx.numel() * 4 + out.numel() * 4)

    # K3 on the render's real backward input
    n_faces, row = table.shape[1], table.shape[2]
    g = l1_render_grad(batch, fid, cov, out)
    k3_eval = k3_launch(g, idx, n_faces, "the MSAA render's backward input, eval hand")
    k3_plain_ms = time_ms(lambda: k2.scatter_rows_plain(g, idx, n_faces), reps=20)
    dst = torch.where(idx >= 0, idx.long() + b_idx * n_faces, B * n_faces).reshape(-1)
    g2 = g.reshape(-1, row)
    k3_lib_ms = time_ms(lambda: torch.zeros(B * n_faces + 1, row, device=g.device).index_add_(0, dst, g2),
                        reps=20)
    k3_bound_all, _ = bound(idx.numel() * 4 + g.numel() * 4 + B * n_faces * row * 4)
    print(f"K3: kernel {k3_eval['ms']:.4f} ms, plain {k3_plain_ms:.4f} ms, index_add_ {k3_lib_ms:.4f} ms, "
          f"bound {k3_eval['bound_ms']:.4f} ms ({k3_bound_all:.4f} ms if every gradient row were read)")

    kernels = [
        {"name": "K1 msaa_raster", "route": "cuda", "source": "hifihr_tpu_torch/csrc/raster_msaa.cu",
         "replaces": "hifihr_tpu/render/raster_msaa.py:68", "launches": None,
         "max_abs_err": k1_err, "ms": k1_eval["route_ms"], "parts_ms": k1_eval["parts_ms"],
         "launches_per_route": k1_eval["launches_per_route"], "plain_ms": k1_plain_ms,
         "bound_ms": k1_eval["bound_ms"], "bound_by": k1_eval["bound_by"], "library_ms": None,
         "eval_hand": k1_eval},
        {"name": "K2 gather_rows", "route": "cuda", "source": "hifihr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "hifihr_tpu/render/gather_mxu.py:64", "launches": None,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": lib_ms},
        {"name": "K3 scatter_rows", "route": "cuda", "source": "hifihr_tpu_torch/csrc/scatter_rows.cu",
         "replaces": "hifihr_tpu/render/gather_mxu.py:87", "launches": None,
         "max_abs_err": k3_eval["max_abs_err"], "ms": k3_eval["ms"], "plain_ms": k3_plain_ms,
         "bound_ms": k3_eval["bound_ms"], "bound_by": k3_eval["bound_by"], "library_ms": k3_lib_ms,
         "eval_hand": k3_eval},
    ]
    return kernels


def crafted_scene(device):
    """A 64^2 screen-space scene for K4's edge cases: face 0 has a vertex at
    z = 1e-6 and face 1 zero area (never selected), faces 2 and 3 are wound
    opposite ways, faces 4 and 5 are the same triangle (4 wins the tie)."""
    vs = torch.tensor([[[8.0, 8.0, 1e-6], [56.0, 8.0, 1.0], [32.0, 56.0, 1.0],   # 0
                        [4.0, 4.0, 0.5], [20.0, 20.0, 0.5], [36.0, 36.0, 0.5],  # 1: collinear
                        [2.0, 40.0, 0.8], [30.0, 62.0, 0.9], [2.0, 62.0, 0.7],  # 2
                        [60.0, 2.0, 0.6], [40.0, 30.0, 0.8], [60.0, 30.0, 0.7],  # 3
                        [10.0, 10.0, 0.4], [50.0, 12.0, 0.45], [30.0, 40.0, 0.5]]],
                      device=device)
    faces = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11], [12, 13, 14], [12, 13, 14]],
                         device=device)
    return vs, faces


def face_boxes(tri: torch.Tensor) -> torch.Tensor:
    """(B, F, 4) [umin, umax, vmin, vmax] of K4's input, inf where a vertex
    lies at z <= 1e-6."""
    valid = (tri[..., 2::3] > 1e-6).all(-1, keepdim=True)
    u, v = tri[..., 0::3], tri[..., 1::3]
    box = torch.stack([u.amin(-1), u.amax(-1), v.amin(-1), v.amax(-1)], dim=-1)
    return torch.where(valid, box, torch.full_like(box, float("inf")))


def ssaa_fetch_grads(idx: torch.Tensor, d_att: int) -> tuple:
    """Seeded cotangents of the SSAA per-pixel corner fetch, zero on
    background: (B, P, 9) for the screen triangle, (B, P, d_att) for the
    attributes."""
    covered = (idx >= 0)[..., None].float()
    gen = torch.Generator(device=idx.device).manual_seed(0)
    g_tri = torch.randn(*idx.shape, 9, device=idx.device, generator=gen) * covered
    return g_tri, torch.randn(*idx.shape, d_att, device=idx.device, generator=gen) * covered


def ssaa_fetch_times(vs: torch.Tensor, faces: torch.Tensor, fid: torch.Tensor, attrs: torch.Tensor) -> dict:
    """Forward and backward of the SSAA per-pixel corner fetch of the screen
    triangle (9 floats) and [albedo | normals | points] (27 floats): through
    K2 and K3 with idx = -1 on background (the port's route), and by
    advanced indexing with face 0 on background (JAX's form), whose
    backward is torch's index_put_ with accumulate. One cotangent, zero on
    background, for both. Also K3 alone at this shape, beside its bound."""
    from hifihr_tpu_torch.render.gather import gather_rows, scatter_rows
    from hifihr_tpu_torch.render.mesh import gather_face_rows

    n, size = fid.shape[0], fid.shape[1]
    idx = fid.reshape(n, -1).contiguous()
    g_tri, g_att = ssaa_fetch_grads(idx, 3 * attrs.shape[-1])
    vs_r, at_r = vs.detach().requires_grad_(), attrs.detach().requires_grad_()
    b_idx = torch.arange(n, device=vs.device)[:, None, None, None]
    pix_faces = faces[fid.clamp(min=0).long()]

    def k2_route():
        tri = gather_rows(gather_face_rows(vs_r, faces).contiguous(), idx)
        att = gather_rows(gather_face_rows(at_r, faces).contiguous(), idx)
        return torch.autograd.grad([tri, att], [vs_r, at_r], [g_tri, g_att])

    def index_route():
        tri = vs_r[b_idx, pix_faces].reshape(g_tri.shape)
        att = at_r[b_idx, pix_faces].reshape(g_att.shape)
        return torch.autograd.grad([tri, att], [vs_r, at_r], [g_tri, g_att])

    a, b = k2_route(), index_route()
    err = max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(a, b))
    check(err < 1e-5, f"the two SSAA fetch routes give the same gradients ({err})")

    # K3 alone on the wider of the two backward inputs: at 672^2 each face
    # takes ~9x the rows it takes at 224^2, so more atomics meet on one row
    F = faces.shape[0]
    rows = (idx >= 0).sum().item()
    per_face = torch.bincount((idx + torch.arange(n, device=idx.device)[:, None] * F)[idx >= 0])
    k3_bound, k3_by = bound(idx.numel() * 4 + rows * g_att.shape[-1] * 4 + n * F * g_att.shape[-1] * 4,
                            rows * g_att.shape[-1])
    return {"pixels": n * size * size, "k2_k3_ms": time_ms(k2_route, reps=5),
            "indexing_ms": time_ms(index_route, reps=5), "max_rel_grad_diff": err,
            "k3_shape": [n, idx.shape[1], g_att.shape[-1]], "k3_covered_rows": rows,
            "k3_largest_face_rows": per_face.max().item(),
            "k3_ms": time_ms(lambda: scatter_rows(g_att, idx, F), reps=20),
            "k3_bound_ms": k3_bound, "k3_bound_by": k3_by}


def phase_k4(batch: dict) -> dict:
    from hifihr_tpu_torch.render import raster as k4
    from hifihr_tpu_torch.render.renderer import _scale_intrinsics

    size = S * AA
    verts, _, faces, attrs = posed_meshes(batch)
    verts, attrs = verts[:SSAA_B], attrs[:SSAA_B]
    vs = k4.project_to_screen(verts, _scale_intrinsics(batch["Ks"][:SSAA_B], float(AA)))
    tri = k4.face_triangles(vs, faces)
    fid, zb = k4.rasterize_face_id(vs, faces, size)
    fid_p, zb_p = k4.select_face_id_plain(tri, size)
    torch.cuda.synchronize()
    covered = fid_p >= 0
    print(f"K4: {tuple(fid.shape)}, covered pixels {covered.float().mean().item():.4f}, "
          f"face_id mismatches {(fid != fid_p).sum().item()}, zbuf mismatches {(zb != zb_p).sum().item()}")
    check(tuple(tri.shape) == (SSAA_B, 1538, 9), f"K4 input shape {tuple(tri.shape)}")
    check(torch.equal(fid, fid_p), "K4 face_id equals the plain version")
    check(torch.equal(zb, zb_p), "K4 zbuf equals the plain version")
    check(covered.float().mean().item() > 0.01, "K4 scene covers pixels")
    k4_err = (zb[covered] - zb_p[covered]).abs().max().item()

    cvs, cfaces = crafted_scene(vs.device)
    cf, cz = k4.rasterize_face_id(cvs, cfaces, 64)
    cf_p, cz_p = k4.rasterize_face_id_plain(cvs, cfaces, 64)
    torch.cuda.synchronize()
    seen = set(torch.unique(cf).tolist())
    print(f"K4 crafted 64^2 scene: faces selected {sorted(seen)}")
    check(torch.equal(cf, cf_p) and torch.equal(cz, cz_p), "K4 equals the plain version on the crafted scene")
    check(seen == {-1, 2, 3, 4}, f"crafted scene: only faces 2, 3 (both windings) and 4 (the tie) win: {seen}")

    k4_ms = time_ms(lambda: k4.select_face_id_cuda(tri, size), reps=20)
    k4_plain_ms = time_ms(lambda: k4.select_face_id_plain(tri, size), reps=1, groups=2)
    boxes = face_boxes(tri)
    pairs = box_pairs(boxes, size)
    k4_bound, k4_by = bound(tri.numel() * 4 + 2 * fid.numel() * 4, pairs * K4_OPS_PER_PAIR)
    print(f"K4: kernel {k4_ms:.4f} ms, plain {k4_plain_ms:.2f} ms, {pairs} (pixel, face) pairs, "
          f"{tile_pairs(boxes, size)} walked by the tiles, bound {k4_bound:.4f} ms ({k4_by})")

    fetch = ssaa_fetch_times(vs, faces, fid, torch.cat([attrs, verts], dim=-1))
    print("SSAA corner fetch, forward + backward: " + json.dumps(fetch))
    return {"name": "K4 face_raster", "route": "cuda", "source": "hifihr_tpu_torch/csrc/raster_face.cu",
            "replaces": "hifihr_tpu/render/raster_pallas.py:26", "launches": None,
            "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
            "bound_by": k4_by, "library_ms": None}


# the kernels each render mode's steps launch; the others must stay at 0
PATH_KERNELS = {"msaa": ("K1 msaa_raster", "K2 gather_rows", "K3 scatter_rows"),
                "ssaa": ("K4 face_raster", "K2 gather_rows", "K3 scatter_rows")}


def phase_eval_step(batch: dict, profile: bool, aa_mode: str = "msaa") -> dict:
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_eval_step

    n = batch["imgs"].shape[0]
    cfg = Config(pretrain="res50", hand_model="mano", render=True, light_estimation=True,
                 image_size=S, aa_factor=AA, aa_mode=aa_mode, compute_dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, "FreiHand", cfg)
    step(batch)  # cuDNN autotuning and allocator warm-up
    torch.cuda.synchronize()

    reset_launches()
    out = step(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    check_k1_route_launches(launches, f"the {aa_mode} eval step")
    print(f"{aa_mode} eval step launches: {launches}")
    raster, gather, scatter = PATH_KERNELS[aa_mode]
    check(launches[raster] == 1 and launches[gather] > 0 and launches[scatter] == 0
          and sum(launches.values()) == launches[raster] + launches[gather],
          f"the {aa_mode} rasteriser once, K2, and no backward or other rasteriser on the eval path: {launches}")

    shapes = {"joints": (n, 21, 3), "mano_verts": (n, 778, 3), "j2d": (n, 21, 2),
              "re_img": (n, S, S, 3), "re_sil": (n, S, S, 1), "re_depth": (n, S, S)}
    for k, shp in shapes.items():
        check(tuple(out[k].shape) == shp, f"{k} shape {tuple(out[k].shape)} != {shp}")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{k} finite")
    sil = out["re_sil"]
    sil_frac = (sil > 0).float().mean().item()
    check(bool(((sil == 0) | (sil == 255)).all()), "re_sil in {0, 255}")
    check(sil_frac > 0.001, f"re_sil covers pixels ({sil_frac})")
    print(f"{aa_mode} eval step outputs finite; re_sil covers {sil_frac:.4f} of pixels")

    if aa_mode == "msaa":  # the flagship in fp32 on 2 images
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        eval_card_vs_cpu(cfg32, {k: v[:2].cpu() for k, v in batch.items()}, "the flagship, 2 images")
    else:
        eval_card_vs_cpu(Config(**dict(SLICE_CFG, aa_mode=aa_mode)), slice_batch(),
                         "res18, 32 px, 8 images")

    torch.cuda.reset_peak_memory_stats()
    print(f"{aa_mode} eval step: " + json.dumps(time_steps(lambda: step(batch), n)))
    if profile:
        profile_steps(step, batch)
        if aa_mode == "msaa":
            stage_times(model, batch)
    return launches


def eval_card_vs_cpu(cfg32, batch: dict, what: str) -> None:
    """The fp32 eval step on the card (kernels) against the CPU (plain
    versions) on a host batch."""
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_eval_step

    gpu32 = make_eval_step(build_model(cfg32, device="cuda", seed=0), "FreiHand", cfg32)(
        {k: v.cuda() for k, v in batch.items()})
    cpu32 = make_eval_step(build_model(cfg32, device="cpu", seed=0), "FreiHand", cfg32)(batch)
    diffs = {k: (gpu32[k].cpu() - cpu32[k]).abs().max().item() for k in ("joints", "mano_verts", "j2d")}
    # a pixel whose nearest face flips between the two runs (ulp-level
    # geometry differences) differs by a whole colour or depth: count shares
    sil_mismatch = (gpu32["re_sil"].cpu() != cpu32["re_sil"]).float().mean().item()
    off = {k: ((gpu32[k].cpu() - cpu32[k]).abs() > 1e-4).float().mean().item()
           for k in ("re_img", "re_depth")}
    print(f"fp32 {cfg32.aa_mode} eval step, card vs CPU ({what}): max abs {diffs}, re_sil mismatch "
          f"share {sil_mismatch}, share off by > 1e-4 {off}")
    check(diffs["joints"] < 1e-5 and diffs["mano_verts"] < 1e-5, "joints and verts within 1e-5 m")
    check(diffs["j2d"] < 1e-3, "j2d within 1e-3 px")
    check(sil_mismatch <= 1e-3 and max(off.values()) <= 5e-3, "render agrees with the CPU plain path")


def time_steps(run, n: int) -> dict:
    """Median, min and max of STEPS steps of n images each timed with CUDA
    events, the mean of STEPS steps run back to back (host clock,
    synchronised), and the peak memory since the caller's reset."""
    times = []
    for _ in range(STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    t0 = time.perf_counter()
    for _ in range(STEPS):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / STEPS * 1e3
    med = statistics.median(times)
    return {"batch": n, "image_size": S, "steps": STEPS, "median_ms": med,
            "images_per_s": n / med * 1e3, "min_ms": min(times), "max_ms": max(times),
            "back_to_back_ms": wall_ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def reset_launches() -> None:
    from hifihr_tpu_torch.render import gather, raster, raster_msaa

    raster_msaa.rasterize_msaa.launches = 0
    raster_msaa.rasterize_msaa.device_launches = 0
    gather.gather_rows.launches = 0
    gather.scatter_rows.launches = 0
    raster.rasterize_face_id.launches = 0


def read_launches() -> dict:
    from hifihr_tpu_torch.render import gather, raster, raster_msaa

    return {"K1 msaa_raster": raster_msaa.rasterize_msaa.launches,
            "K2 gather_rows": gather.gather_rows.launches,
            "K3 scatter_rows": gather.scatter_rows.launches,
            "K4 face_raster": raster.rasterize_face_id.launches}


def check_k1_route_launches(launches: dict, what: str) -> None:
    """Every K1 route of the run just read made its three launches, as the C
    route counted them."""
    from hifihr_tpu_torch.render import raster_msaa

    made = raster_msaa.rasterize_msaa.device_launches
    check(made == len(K1_PARTS) * launches["K1 msaa_raster"],
          f"{len(K1_PARTS)} launches in each of the {launches['K1 msaa_raster']} K1 routes of {what}: {made}")


def slice_batch(n: int = 8, size: int = 32) -> dict:
    """The seeded batch of tests/test_torch_train_slice.py, on the host."""
    rng = np.random.RandomState(0)
    f = size * 1.8
    K = np.asarray([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    b = {
        "imgs": rng.rand(n, size, size, 3).astype(np.float32),
        "Ks": np.tile(K[None], (n, 1, 1)),
        "root_xyz": np.tile(np.asarray([[[0.0, 0.0, 0.5]]], np.float32), (n, 1, 1)),
        "joints": (rng.randn(n, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "j2d_gt": (rng.rand(n, 21, 2) * size).astype(np.float32),
        "verts": (rng.randn(n, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "segms_gt": (rng.rand(n, size, size) > 0.6).astype(np.float32),
        "texture_con": rng.uniform(0.5, 1.0, n).astype(np.float32),
        "scales": np.full((n,), 0.0282, np.float32),
    }
    return {k: torch.tensor(v) for k, v in b.items()}


def one_train_step(cfg, batch: dict, device: str):
    """One train step of a freshly built model (seed 0) on `device`: the
    loss dict as floats and every parameter's gradient on the host."""
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    model = build_model(cfg, device=device, seed=0)
    state = create_train_state(model, cfg)
    step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    _, d = step(state, {k: v.to(device) for k, v in batch.items()}, make_sched(cfg, 0, device=device))
    return ({k: v.item() for k, v in d.items()},
            {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()})


def train_config(aa_mode: str):
    """The flagship train step's configuration: the bench losses, Adam at
    lr 1e-3."""
    from hifihr_tpu_torch.config import Config

    return Config(pretrain="res50", hand_model="mano", render=True, light_estimation=True,
                  image_size=S, aa_factor=AA, aa_mode=aa_mode, compute_dtype="bfloat16",
                  losses=LOSSES, optimizer="Adam", init_lr=1e-3)


def phase_train_step(batch: dict, profile: bool, aa_mode: str = "msaa") -> tuple:
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    cfg = train_config(aa_mode)
    images = batch["imgs"].shape[0]
    model = build_model(cfg, device="cuda", seed=0)
    state = create_train_state(model, cfg, batch)
    step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    sched = make_sched(cfg, 0)
    totals = []
    # the first step renders the seeded init's hand: keep the inputs K1 and
    # K3 get there
    with captured_kernel_inputs() as first:
        state, d = step(state, batch, sched)
    totals.append(d["total"])
    state, d = step(state, batch, sched)  # allocator warm-up; device constants made once
    totals.append(d["total"])
    torch.cuda.synchronize()

    before = state.optimizer.flat.clone()
    reset_launches()
    state, d = step(state, batch, sched)
    torch.cuda.synchronize()
    launches = read_launches()
    check_k1_route_launches(launches, f"the {aa_mode} train step")
    totals.append(d["total"])
    print(f"{aa_mode} train step launches: {launches}")
    path = PATH_KERNELS[aa_mode]
    check(all(launches[k] > 0 for k in path) and sum(launches[k] for k in path) == sum(launches.values()),
          f"{', '.join(path)} and no other kernel ran on the {aa_mode} train path: {launches}")
    # K1 and K3 on the step's own inputs: the first step's here, freed before
    # the timed steps, and a later step's at the end
    hand = {"K1": [], "K3": []}

    def kernels_on(got: dict, when: str) -> None:
        check(len(got["K1"]) == launches["K1 msaa_raster"] and len(got["K3"]) == launches["K3 scatter_rows"],
              f"one capture per K1 route and K3 launch of the {aa_mode} train step")
        hand["K1"].extend(k1_route(coef, bbox, f"the {aa_mode} train step's hand at {when}", size)
                          for coef, bbox, size in got["K1"])
        hand["K3"].extend(k3_launch(g, idx, n, f"launch {i} of the {aa_mode} train step at {when}")
                          for i, (g, idx, n) in enumerate(got["K3"]))
        got["K1"].clear()
        got["K3"].clear()

    kernels_on(first, "step 1")
    losses = {k: v.item() for k, v in d.items()}
    print(f"{aa_mode} train step losses: " + json.dumps(losses))
    check(set(losses) == set(FIRED) | {"skipped"}, f"the 15 terms, total and skipped: {sorted(losses)}")
    check(all(np.isfinite(v) for v in losses.values()), "loss terms finite")
    check(losses["skipped"] == 0.0, "the step was not skipped")
    changed = (state.optimizer.flat != before).float().mean().item()
    print(f"{aa_mode} train step changed {changed:.4f} of the {before.numel()} trained parameters")
    check(changed > 0.5, "the parameters changed")

    # no host sync: first list every synchronising call of one step, then
    # run one under "error", where any raises
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, d = step(state, batch, sched)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    totals.append(d["total"])
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)]
    check(not syncs, f"no synchronising call in the train step: {syncs}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, d = step(state, batch, sched)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    totals.append(d["total"])
    print(f"{aa_mode} train step: one step ran under set_sync_debug_mode('error'), no host sync")
    for _ in range(10 - len(totals)):
        state, d = step(state, batch, sched)
        totals.append(d["total"])
    trajectory = [t.item() for t in totals]
    print(f"{aa_mode} train loss trajectory (10 steps): " + json.dumps(trajectory))
    check(all(np.isfinite(trajectory)) and int(state.step) == 10, f"10 updates taken ({int(state.step)})")

    # fp32 on the card (kernels) against fp32 on the CPU (plain versions), in
    # the train-slice test's configuration. At the flagship's (res50, 224^2,
    # random init) one ulp of input moves the CPU's own encoder gradients by
    # 3%, so no tighter bound could hold there (ROADMAP.md section 3)
    small_cfg = Config(**dict(SLICE_CFG, aa_mode=aa_mode))
    small = slice_batch()
    (gl, gg), (cl, cg) = one_train_step(small_cfg, small, "cuda"), one_train_step(small_cfg, small, "cpu")
    term_err = {k: abs(gl[k] - cl[k]) / max(abs(cl[k]), 1e-30) for k in FIRED}
    grad_err = {}
    for name, ref in cg.items():
        if name.startswith("hand_encoder.base_fc") and name.endswith(".bias"):
            continue  # zero in exact arithmetic: a bias that feeds a train-mode BatchNorm
        nr = ref.norm().item()
        grad_err[name] = (gg[name] - ref).norm().item() / nr if nr > 0 else gg[name].norm().item()
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:4]
    print(f"fp32 {aa_mode} train step (res18, 32 px), card vs CPU on 8 images: worst loss term rel err "
          f"{max(term_err.items(), key=lambda kv: kv[1])}, worst gradient rel L2 {worst}")
    check(max(term_err.values()) <= 1e-4, "loss terms within 1e-4 of the CPU plain path")
    check(max(grad_err.values()) <= 1e-3, "gradients within 1e-3 relative L2 of the CPU plain path")

    torch.cuda.reset_peak_memory_stats()
    print(f"{aa_mode} train step: " + json.dumps(time_steps(lambda: step(state, batch, sched), images)))
    if profile:
        profile_steps(lambda b: step(state, b, sched), batch)

    # a step after the timed ones, whose hand the updates have grown
    with captured_kernel_inputs() as later:
        state, _ = step(state, batch, sched)
    kernels_on(later, f"step {int(state.step)}")
    return launches, hand


def stage_times(model, batch) -> None:
    """Time of each stage of the eval step, run alone back to back (CUDA
    events, so host dispatch that outruns the device is included)."""
    import torch.nn.functional as Fn

    from hifihr_tpu_torch.hand.mano import regress_joints_frei
    from hifihr_tpu_torch.networks.resnet import normalize_imagenet
    from hifihr_tpu_torch.render.shading import DirectionalLight

    imgs, K, root_xyz = batch["imgs"], batch["Ks"], batch["root_xyz"]
    with torch.inference_mode():
        def encoder():
            with model._encoder_autocast(imgs.device):
                return model.encoder(imgs)

        def mano():
            out = model.mano(hp["pose_params"], hp["shape_params"])
            return out, regress_joints_frei(out.verts, model.mano.J_regressor)

        stem = model.encoder.backbone.conv1
        x = normalize_imagenet(imgs).permute(0, 3, 1, 2)

        def stem_s2d():
            with model._encoder_autocast(imgs.device):
                return stem(x)

        def stem_direct():  # the same conv as one 8x8 / stride-2 cuDNN call
            with model._encoder_autocast(imgs.device):
                return Fn.conv2d(Fn.pad(x, (4, 2, 4, 2)), stem.weight, stride=2)

        low, feat = encoder()
        lp = model.light_estimator(low.float())
        hp = model.hand_encoder(feat)
        out, joints = mano()
        verts = out.verts - joints[:, 9:10] + root_xyz
        light = DirectionalLight.from_estimator(lp["colors"], lp["directions"])
        albedo = model._vertex_albedo(B)
        stages = {
            "encoder (ResNet-50, bf16)": encoder,
            "  of it: stem, s2d form (the port's)": stem_s2d,
            "  stem as a direct 8x8 conv, for comparison": stem_direct,
            "light estimator": lambda: model.light_estimator(low.float()),
            "hand encoder heads": lambda: model.hand_encoder(feat),
            "MANO + joints": mano,
            "renderer (all)": lambda: model.renderer(verts, albedo, K, light),
            "  of it: K1 prep + kernel": lambda: model.renderer.select_faces(verts, K),
        }
        for name, fn in stages.items():
            print(f"stage {name}: {time_ms(fn, reps=5):.4f} ms")


def profile_steps(step, batch, n: int = 3) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_total = sum(e.self_device_time_total for e in rows)
    n_launch = sum(e.count for e in rows)
    print(f"profile: {n} steps, wall {wall_us / n / 1e3:.3f} ms/step, device busy "
          f"{dev_total / n / 1e3:.3f} ms/step ({dev_total / wall_us:.3f} of wall), "
          f"{n_launch / n:.0f} kernel launches/step")
    ranked = sorted(rows, key=lambda e: -e.self_device_time_total)
    ours = ("msaa_", "gather_rows", "scatter_rows", "face_raster", "Memset")  # the port's kernels
    for i, e in enumerate(ranked):
        if i < 25 or any(k in e.key for k in ours):
            print(f"  {e.self_device_time_total / n / 1e3:9.4f} ms/step  x{e.count // n:<4d} {e.key[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few eval and train steps of each render mode")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hifihr_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    kernels.build_all(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")

    from hifihr_tpu_torch.training.steps import set_fp32_numerics

    set_fp32_numerics()
    batch = flagship_batch("cuda")
    table = phase_kernels(batch) + [phase_k4(batch)]
    eval_launches = phase_eval_step(batch, args.profile)
    train_launches, train_hand = phase_train_step(batch, args.profile)
    ssaa_batch = {k: v[:SSAA_B] for k, v in batch.items()}
    ssaa_eval_launches = phase_eval_step(ssaa_batch, args.profile, aa_mode="ssaa")
    ssaa_train_launches, ssaa_train_hand = phase_train_step(ssaa_batch, args.profile, aa_mode="ssaa")
    table[0]["train_hand"] = train_hand["K1"] + ssaa_train_hand["K1"]
    table[2]["train_hand"] = train_hand["K3"] + ssaa_train_hand["K3"]
    for k in table:
        name = k["name"]
        if name.startswith("K4"):
            k["launches"], k["launches_train_step"] = ssaa_eval_launches[name], ssaa_train_launches[name]
        else:
            k["launches"] = (train_launches if name.startswith("K3") else eval_launches)[name]
            k["launches_train_step"] = train_launches[name]
        k["launches_ssaa_eval_step"] = ssaa_eval_launches[name]
        k["launches_ssaa_train_step"] = ssaa_train_launches[name]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
