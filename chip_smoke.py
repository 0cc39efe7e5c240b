"""Drive the PyTorch port (hifihr_tpu_torch) on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py` (one CUDA card, nvcc
under /usr/local/cuda or on PATH). `--profile` adds a torch.profiler pass
over a few eval steps and a few train steps. Phases:

  1. the card's name and power limit (nvidia-smi)
  2. build the CUDA kernels from hifihr_tpu_torch/csrc/ into
     build/hifihr_tpu_torch/ (one nvcc per source, in parallel)
  3. K1 (MSAA face selection) against its plain PyTorch version on 64 posed
     MANO meshes at 224^2: face_id, coverage and zbuf exactly equal
  4. K2 (per-pixel row gather) against its plain version on the table and
     face ids of phase 3, (64, 1538, 27) x (64, 50176): bit-equal
  5. K3 (the scatter-add backward of K2) against its plain version on the
     render's real backward input: the (64, 50176, 27) gradient that an L1
     loss on the shaded phase-3 render sends to K2's output, and K1's face
     ids. fp32 atomics on both sides, so each entry summed from n rows is
     held within 2 (n - 1) 2^-24 sum|g| of the other
  6. the flagship eval step (ResNet-50 + MANO + MSAA render, batch 64,
     224^2, bf16 encoder, seeded random weights): K1 and K2 launched, the
     outputs finite and the silhouette non-empty; the same step in fp32 on
     the card against the plain versions on the CPU on two images; the
     median step time and images/s over 15 steps (CUDA events)
  7. the flagship train step (the same model and batch, the bench losses,
     backward through the render, Adam): K1, K2 and K3 launched, the 15
     loss terms and the total finite and the step not skipped, the
     parameters changed, a 10-step loss trajectory, one step under
     torch.cuda.set_sync_debug_mode("error") (no host sync), the fp32 step
     on the card against the plain versions on the CPU in the train-slice
     test's configuration (res18, 32 px, 8 images; loss terms within 1e-4,
     each gradient within 1e-3 relative L2), the median step time and
     images/s over 15 steps, and the peak memory
  8. one `{"kernels": [...]}` line: per kernel its time, launches in one
     step of its path (K1 and K2 the eval step, K3 the train step; all
     three in the train step under `launches_train_step`), error against
     the plain version, the plain version's time, the bound and, for K2 and
     K3, one PyTorch call's time (indexing; `index_add_`)

Any failed check raises, so the exit code is nonzero; so it is without CUDA.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
    and K2 get on the main path."""
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
    return vs, faces, attrs


def k1_pairs(bbox: torch.Tensor) -> int:
    """(pixel, face) pairs whose face box touches the pixel: the work K1
    needs for these inputs, however it culls."""
    valid = torch.isfinite(bbox[..., 0])
    bb = torch.where(valid[..., None], bbox, torch.zeros_like(bbox))
    x0 = bb[..., 0].floor().clamp(0, S - 1)
    x1 = bb[..., 1].floor().clamp(0, S - 1)
    y0 = bb[..., 2].floor().clamp(0, S - 1)
    y1 = bb[..., 3].floor().clamp(0, S - 1)
    on = valid & (bb[..., 1] >= 0) & (bb[..., 0] < S) & (bb[..., 3] >= 0) & (bb[..., 2] < S)
    n = (x1 - x0 + 1) * (y1 - y0 + 1)
    return int(torch.where(on, n, torch.zeros_like(n)).sum().item())


def bound(nbytes: int, ops: int = 0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(batch: dict) -> list:
    from hifihr_tpu_torch.render import gather as k2
    from hifihr_tpu_torch.render import raster_msaa as k1
    from hifihr_tpu_torch.render.interpolate import interpolate_rows, pack_face_table
    from hifihr_tpu_torch.render.renderer import _pixel_ray_points
    from hifihr_tpu_torch.render.shading import DirectionalLight, phong_shade

    vs, faces, attrs = posed_meshes(batch)
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

    coef, bbox = k1.msaa_prep(vs, faces)  # K1's inputs, timed apart from the kernel
    k1_ms = time_ms(lambda: k1.msaa_select_cuda(coef, bbox, S), reps=20)
    k1_plain_ms = time_ms(lambda: k1.msaa_select_plain(coef, S), reps=1, groups=2)
    prep_ms = time_ms(lambda: k1.msaa_prep(vs, faces), reps=20)
    pairs = k1_pairs(bbox)
    k1_bytes = (coef.numel() + bbox.numel()) * 4 + 3 * B * S * S * 4
    k1_bound, k1_by = bound(k1_bytes, pairs * K1_OPS_PER_PAIR)
    print(f"K1: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.2f} ms, shared prep {prep_ms:.4f} ms, "
          f"{pairs} (pixel, face) pairs")

    b_idx = torch.arange(B, device=idx.device)[:, None]
    k2_ms = time_ms(lambda: k2.gather_rows(table, idx), reps=50)
    k2_plain_ms = time_ms(lambda: k2.gather_rows_plain(table, idx), reps=20)
    lib_ms = time_ms(lambda: table[b_idx, idx.clamp(min=0).long()] * (idx >= 0)[..., None], reps=20)
    k2_bound, k2_by = bound(table.numel() * 4 + idx.numel() * 4 + out.numel() * 4)

    # K3 on the render's real backward input: the gradient that an L1 loss
    # on the shaded render sends to K2's output
    n_faces, row = table.shape[1], table.shape[2]
    pix = out.detach().requires_grad_()
    attrs_px, mask, zbuf = interpolate_rows(fid, pix.reshape(B, S, S, row))
    points = _pixel_ray_points(zbuf, mask, batch["Ks"], S)
    rgb = phong_shade(attrs_px[..., :3], attrs_px[..., 3:6], points,
                      DirectionalLight.default(B, device=pix.device)) * cov[..., None]
    g = torch.autograd.grad((rgb - batch["imgs"]).abs().mean(), pix)[0].contiguous()
    d3 = k2.scatter_rows(g, idx, n_faces)
    ref3 = k2.scatter_rows_plain(g, idx, n_faces)
    torch.cuda.synchronize()
    # both sides sum in fp32 with atomics; an entry of n rows lies within
    # (n - 1) 2^-24 sum|g| of the exact sum
    rows = k2.scatter_rows_plain(torch.ones_like(g[..., :1]), idx, n_faces)
    abs_sum = k2.scatter_rows_plain(g.abs(), idx, n_faces)
    tol = 2.0 * (rows - 1).clamp(min=0) * 2.0**-24 * abs_sum
    k3_err = (d3 - ref3).abs().max().item()
    check(tuple(d3.shape) == (B, n_faces, row), f"K3 shape {tuple(d3.shape)}")
    check(bool(((d3 - ref3).abs() <= tol).all()), f"K3 within the atomics bound of the plain version ({k3_err})")
    check(g.abs().sum().item() > 0 and d3.abs().sum().item() > 0, "K3 input and output non-zero")
    covered_rows = int((idx >= 0).sum().item())
    print(f"K3: max abs err {k3_err:.3e}, within bound; {covered_rows} covered rows read of {idx.numel()}; "
          f"largest face {int(rows.max().item())} rows")
    k3_ms = time_ms(lambda: k2.scatter_rows(g, idx, n_faces), reps=50)
    k3_plain_ms = time_ms(lambda: k2.scatter_rows_plain(g, idx, n_faces), reps=20)
    dst = torch.where(idx >= 0, idx.long() + b_idx * n_faces, B * n_faces).reshape(-1)
    g2 = g.reshape(-1, row)
    k3_lib_ms = time_ms(lambda: torch.zeros(B * n_faces + 1, row, device=g.device).index_add_(0, dst, g2),
                        reps=20)
    # the bytes the work needs: idx, the gradient rows of covered pixels, the output
    k3_bound, k3_by = bound(idx.numel() * 4 + covered_rows * row * 4 + d3.numel() * 4, covered_rows * row)
    k3_bound_all, _ = bound(idx.numel() * 4 + g.numel() * 4 + d3.numel() * 4)
    print(f"K3: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms, index_add_ {k3_lib_ms:.4f} ms, "
          f"bound {k3_bound:.4f} ms ({k3_by}; {k3_bound_all:.4f} ms if every gradient row were read)")

    kernels = [
        {"name": "K1 msaa_raster", "route": "cuda", "source": "hifihr_tpu_torch/csrc/raster_msaa.cu",
         "replaces": "hifihr_tpu/render/raster_msaa.py:68", "launches": None,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "K2 gather_rows", "route": "cuda", "source": "hifihr_tpu_torch/csrc/gather_rows.cu",
         "replaces": "hifihr_tpu/render/gather_mxu.py:64", "launches": None,
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": lib_ms},
        {"name": "K3 scatter_rows", "route": "cuda", "source": "hifihr_tpu_torch/csrc/scatter_rows.cu",
         "replaces": "hifihr_tpu/render/gather_mxu.py:87", "launches": None,
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib_ms},
    ]
    return kernels


def phase_eval_step(batch: dict, profile: bool) -> dict:
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.render import gather as k2
    from hifihr_tpu_torch.render import raster_msaa as k1
    from hifihr_tpu_torch.training.steps import make_eval_step

    cfg = Config(pretrain="res50", hand_model="mano", render=True, light_estimation=True,
                 image_size=S, aa_factor=3, aa_mode="msaa", compute_dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, "FreiHand", cfg)
    step(batch)  # cuDNN autotuning and allocator warm-up
    torch.cuda.synchronize()

    reset_launches()
    out = step(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"eval step launches: {launches}")
    check(launches["K1 msaa_raster"] > 0 and launches["K2 gather_rows"] > 0 and launches["K3 scatter_rows"] == 0,
          f"K1 and K2, and no backward, ran on the eval path: {launches}")

    shapes = {"joints": (B, 21, 3), "mano_verts": (B, 778, 3), "j2d": (B, 21, 2),
              "re_img": (B, S, S, 3), "re_sil": (B, S, S, 1), "re_depth": (B, S, S)}
    for k, shp in shapes.items():
        check(tuple(out[k].shape) == shp, f"{k} shape {tuple(out[k].shape)} != {shp}")
    for k, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{k} finite")
    sil = out["re_sil"]
    sil_frac = (sil > 0).float().mean().item()
    check(bool(((sil == 0) | (sil == 255)).all()), "re_sil in {0, 255}")
    check(sil_frac > 0.001, f"re_sil covers pixels ({sil_frac})")
    print(f"eval step outputs finite; re_sil covers {sil_frac:.4f} of pixels")

    # fp32 on the card (kernels) against fp32 on the CPU (plain versions), 2 images
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    small = {k: v[:2] for k, v in batch.items()}
    gpu32 = make_eval_step(build_model(cfg32, device="cuda", seed=0), "FreiHand", cfg32)(small)
    cpu32 = make_eval_step(build_model(cfg32, device="cpu", seed=0), "FreiHand", cfg32)(
        {k: v.cpu() for k, v in small.items()})
    diffs = {k: (gpu32[k].cpu() - cpu32[k]).abs().max().item() for k in ("joints", "mano_verts", "j2d")}
    # a pixel whose nearest face flips between the two runs (ulp-level
    # geometry differences) differs by a whole colour or depth: count shares
    sil_mismatch = (gpu32["re_sil"].cpu() != cpu32["re_sil"]).float().mean().item()
    off = {k: ((gpu32[k].cpu() - cpu32[k]).abs() > 1e-4).float().mean().item()
           for k in ("re_img", "re_depth")}
    print(f"fp32 card vs CPU on 2 images: max abs {diffs}, re_sil mismatch share {sil_mismatch}, "
          f"share off by > 1e-4 {off}")
    check(diffs["joints"] < 1e-5 and diffs["mano_verts"] < 1e-5, "joints and verts within 1e-5 m")
    check(diffs["j2d"] < 1e-3, "j2d within 1e-3 px")
    check(sil_mismatch <= 1e-3 and max(off.values()) <= 5e-3, "render agrees with the CPU plain path")

    torch.cuda.reset_peak_memory_stats()
    print("eval step: " + json.dumps(time_steps(lambda: step(batch))))
    if profile:
        profile_steps(step, batch)
        stage_times(model, batch)
    return launches


def time_steps(run) -> dict:
    """Median, min and max of STEPS steps each timed with CUDA events, the
    mean of STEPS steps run back to back (host clock, synchronised), and
    the peak memory since the caller's reset."""
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
    return {"batch": B, "image_size": S, "steps": STEPS, "median_ms": med,
            "images_per_s": B / med * 1e3, "min_ms": min(times), "max_ms": max(times),
            "back_to_back_ms": wall_ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def reset_launches() -> None:
    from hifihr_tpu_torch.render import gather, raster_msaa

    raster_msaa.rasterize_msaa.launches = 0
    gather.gather_rows.launches = 0
    gather.scatter_rows.launches = 0


def read_launches() -> dict:
    from hifihr_tpu_torch.render import gather, raster_msaa

    return {"K1 msaa_raster": raster_msaa.rasterize_msaa.launches,
            "K2 gather_rows": gather.gather_rows.launches,
            "K3 scatter_rows": gather.scatter_rows.launches}


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


def phase_train_step(batch: dict, profile: bool) -> dict:
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    cfg = Config(pretrain="res50", hand_model="mano", render=True, light_estimation=True,
                 image_size=S, aa_factor=3, aa_mode="msaa", compute_dtype="bfloat16",
                 losses=LOSSES, optimizer="Adam", init_lr=1e-3)
    model = build_model(cfg, device="cuda", seed=0)
    state = create_train_state(model, cfg, batch)
    step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    sched = make_sched(cfg, 0)
    totals = []
    for _ in range(2):  # allocator warm-up; device constants made once
        state, d = step(state, batch, sched)
        totals.append(d["total"])
    torch.cuda.synchronize()

    before = state.optimizer.flat.clone()
    reset_launches()
    state, d = step(state, batch, sched)
    torch.cuda.synchronize()
    launches = read_launches()
    totals.append(d["total"])
    print(f"train step launches: {launches}")
    check(all(n > 0 for n in launches.values()), f"K1, K2 and K3 ran on the train path: {launches}")
    losses = {k: v.item() for k, v in d.items()}
    print("train step losses: " + json.dumps(losses))
    check(set(losses) == set(FIRED) | {"skipped"}, f"the 15 terms, total and skipped: {sorted(losses)}")
    check(all(np.isfinite(v) for v in losses.values()), "loss terms finite")
    check(losses["skipped"] == 0.0, "the step was not skipped")
    changed = (state.optimizer.flat != before).float().mean().item()
    print(f"train step changed {changed:.4f} of the {before.numel()} trained parameters")
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
    print("train step: one step ran under set_sync_debug_mode('error'), no host sync")
    for _ in range(10 - len(totals)):
        state, d = step(state, batch, sched)
        totals.append(d["total"])
    trajectory = [t.item() for t in totals]
    print("train loss trajectory (10 steps): " + json.dumps(trajectory))
    check(all(np.isfinite(trajectory)) and int(state.step) == 10, f"10 updates taken ({int(state.step)})")

    # fp32 on the card (kernels) against fp32 on the CPU (plain versions), in
    # the train-slice test's configuration. At the flagship's (res50, 224^2,
    # random init) one ulp of input moves the CPU's own encoder gradients by
    # 3%, so no tighter bound could hold there (ROADMAP.md section 3)
    small_cfg = Config(**SLICE_CFG)
    small = slice_batch()
    (gl, gg), (cl, cg) = one_train_step(small_cfg, small, "cuda"), one_train_step(small_cfg, small, "cpu")
    term_err = {k: abs(gl[k] - cl[k]) / max(abs(cl[k]), 1e-30) for k in FIRED}
    grad_err = {}
    for n, ref in cg.items():
        if n.startswith("hand_encoder.base_fc") and n.endswith(".bias"):
            continue  # zero in exact arithmetic: a bias that feeds a train-mode BatchNorm
        nr = ref.norm().item()
        grad_err[n] = (gg[n] - ref).norm().item() / nr if nr > 0 else gg[n].norm().item()
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:4]
    print(f"fp32 train step (res18, 32 px), card vs CPU on 8 images: worst loss term rel err "
          f"{max(term_err.items(), key=lambda kv: kv[1])}, worst gradient rel L2 {worst}")
    check(max(term_err.values()) <= 1e-4, "loss terms within 1e-4 of the CPU plain path")
    check(max(grad_err.values()) <= 1e-3, "gradients within 1e-3 relative L2 of the CPU plain path")

    torch.cuda.reset_peak_memory_stats()
    print("train step: " + json.dumps(time_steps(lambda: step(state, batch, sched))))
    if profile:
        profile_steps(lambda b: step(state, b, sched), batch)
    return launches


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
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:25]:
        print(f"  {e.self_device_time_total / n / 1e3:9.4f} ms/step  x{e.count // n:<4d} {e.key[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="also profile a few eval and train steps")
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
    table = phase_kernels(batch)
    eval_launches = phase_eval_step(batch, args.profile)
    train_launches = phase_train_step(batch, args.profile)
    for k in table:
        own = train_launches if k["name"].startswith("K3") else eval_launches
        k["launches"] = own[k["name"]]
        k["launches_train_step"] = train_launches[k["name"]]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
