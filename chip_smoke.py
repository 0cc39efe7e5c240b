"""Drive the PyTorch port (hifihr_tpu_torch) on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py` (one CUDA card, nvcc
under /usr/local/cuda or on PATH). `--profile` adds a torch.profiler pass
over a few eval steps and a few train steps of every cell. Phases:

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
     median step time and images/s over STEPS (8) steps (CUDA events)
  7. the flagship train step (the same model and batch, the bench losses,
     backward through the render, Adam): K1 (each of its three launches),
     K2 and K3 launched, the 15 loss terms and the total finite and the
     step not skipped, the parameters changed, a 10-step loss trajectory,
     one step under torch.cuda.set_sync_debug_mode("error") (no host sync),
     the fp32 step on the card against the plain versions on the CPU in the
     train-slice test's configuration (res18, 32 px, 8 images; loss terms
     within 1e-4, each gradient within 1e-3 relative L2; the CPU step
     shades the card's face choice, and its own choice is held at 99.5% of
     pixels or more, as in phases 13 and 14), the median step
     time and images/s over STEPS (8) steps, and the peak memory; then K1 and K3
     on the step's own inputs, captured at its first step (the seeded
     init's hand) and at a step after the timed ones (the hand the updates
     have grown): K1 exactly equal to its plain version and K3 within its
     atomics bound, with coverage, rows of the largest face, pairs, time,
     each launch's time and bound
  8. K4 (SSAA face selection: a zero fill, a bin kernel and a fine kernel)
     against its plain version on the first 8 meshes of phase 3 projected
     at K * 3 to 672^2, on a crafted 64^2 scene (a vertex at z <= 1e-6, a
     zero-area face, both windings, two identical faces), on the bin-edge
     scene and on a NIMBLE-sized scene (`torus_scene`, 11,926 faces, 8
     images at 672^2, about 12% and about 60% covered): face_id and zbuf
     exactly equal; the route's time, each launch's device time, the pairs
     it walks and its bound; and the SSAA per-pixel corner fetch forward and backward through K2 and K3
     (the port's route) beside torch's advanced indexing (JAX's form)
  9. the SSAA eval step (the flagship with aa_mode="ssaa", batch 8, the
     cell of bench.py:276-278): K4 launched once per step (its three
     launches counted by the C route), the outputs
     finite and the silhouette non-empty, the median step time and images/s
     over STEPS (8) steps; the fp32 SSAA eval step on the card against the CPU in
     the train-slice test's configuration (res18, 32 px, 8 images)
 10. the SSAA train step (the same model and batch of 8): the checks of
     phase 7, with K4, K2 and K3 launched, the card-against-CPU step in the
     train-slice test's configuration with aa_mode="ssaa", and K3 on each of
     the step's two launches and K4 on its route at both captured steps
 11. K1, K2 and K3 at NIMBLE's shapes, on 64 posed NIMBLE hands (the
     port's NimbleLayer on numpy-seeded pose, shape and appearance, 11,926
     faces, placed as the model places them, at 224^2): K1's route exactly
     equal to its plain version on the first K1_PLAIN_IMAGES images (the
     plain version takes seconds per 8 images at this face count), timed on
     all 64; K2 bit-equal on the (64, 11926, 48) packed table of the corner
     render and on the (64, 5990, 9) corner gather (idx = the flat faces),
     beside the library's indexing and index_select; K3 on the corner
     render's real backward inputs (an L1 loss on the shaded render: the
     48-float per-pixel fetch and the two corner gathers), within its bound
 12. the NIMBLE eval step (the flagship with hand_model="nimble", batch 64,
     224^2, the MSAA corner render): the checks of phase 6, the fp32 step on
     the card against the CPU in the train-slice test's configuration with
     hand_model="nimble"
 13. the NIMBLE train step (the same batch and bench losses, 15 terms): the
     checks of phase 7, with the card-against-CPU step in the slice
     configuration with hand_model="nimble". There the CPU step shades the
     card's face choice, and the CPU's own choice is held at 99.5% of
     pixels or more: two neighbours of NIMBLE's 11,926 faces have near
     equal depths along every shared edge, so the last bits of the vertices
     (fp32 sums in another order on each device) can move the nearer face
     at a pixel, and one such pixel moves a photometric term by ~1e-4
     (tests/test_torch_nimble_slice.py). K1 is held exactly on identical
     inputs in phase 11 and on the step's own inputs at steps 1 and 41
 14. the effb3 eval and train steps: bench's effb3 cell (bench.py:274-275),
     the flagship with pretrain="effb3" (EfficientNet-b3, 1536-channel
     features, the light estimator on its 56x56x32 low tap), batch 64: the
     checks of phases 6 and 7; the fp32 eval step on the card against the
     CPU on 2 images at 224^2, the fp32 train step at 64 px (light
     estimation off, 8 images), where the CPU step shades the card's face
     choice and its own choice is held at 99.5% of pixels or more (the
     vertices' last bits move a few pixels' nearest face at this depth);
     under --profile the encoder's device time alone, in channels-last and
     in plain NCHW, and its share of the step's device time
 15. the paper's config, configs/FreiHAND/full_rhd_freihand.json, loaded by
     Config.from_json (NIMBLE, effb3, L1, 12 losses with the perceptual
     one on the random-feature fallback): the eval step at its val_batch
     (16) and the train step at its train_batch (48), at 224^2, on the
     flagship batch's images with the config's keys and a seeded mask over
     ~40% of pixels (with an all-zero mask the perceptual term is exactly
     0): the checks of phases 12 and 13 with its 12 terms, the perceptual
     term positive, the fp32 steps on the card against the CPU in the
     config at 32 px (the slice test's size); under --profile the
     encoder's and the perceptual loss's shares of device time
 16. one `{"kernels": [...]}` line: per kernel its time (K1 the whole route,
     by CUDA events, as every kernel's `ms`; each launch's device time
     under `parts_ms`, and for K4 their sum under `device_ms`), launches in one step of
     its path (K1 routes and K2 the eval step, K3 the train step, K4 the
     SSAA eval step; the train step of each path under
     `launches_train_step`, and every kernel's count in every other cell's
     steps under `launches_<cell>_eval_step` and
     `launches_<cell>_train_step`, for the ssaa, nimble, effb3 and paper
     cells), error
     against the plain version, the plain version's time, the bound and,
     for K2 and K3, one PyTorch call's time (indexing; `index_add_`); K1,
     K3 and K4 carry their numbers on the train steps' inputs under
     `train_hand` (MANO's, SSAA's and effb3's), K4 also on the NIMBLE-sized
     scenes (`nimble_sized`); K1, K2 and K3 carry their NIMBLE readings
     under `nimble` (ms, plain and library ms, bound, and the NIMBLE and
     paper train steps' inputs); and, from phases 17 and 18, every kernel's
     launches per Trainer step under `launches_trainer_train_step` and
     `launches_trainer_eval_step` (smoke_render) and
     `launches_trainer_paper_train_step` and
     `launches_trainer_paper_eval_step` (the paper config from the tree)
 17. the Trainer through the entry a user calls:
     hifihr_tpu_torch.train.main(["--config_json", <configs/smoke_render.json
     with only base_out_path moved into a temporary directory>]) in-process
     on the card, the shipped config at its own batch (16), size (224^2),
     data (1024 synthetic samples) and epochs (2): both epochs logged with
     no skipped step and every logged term finite, epoch 1's train_loss
     below epoch 0's, each eval record's PA-MPJPE, PA-MPVPE, PCK AUC and
     texture metrics (LPIPS included) finite, texturehand_latest.pt
     written, and the launches per Trainer train step (K1, K2, K3) and
     eval step (K1, K2) equal to the MANO train and eval cells'. Then a
     resume from that model/ dir with total_epochs 3: the log holds epoch 2
     only, the restored parameters, BatchNorm stats and Adam moments equal
     the saved file bit for bit and Adam's count continues (128 at epoch
     2's start); that epoch runs under set_sync_debug_mode("warn"), and its
     synchronising calls may number the print points plus
     TRAINER_EPOCH_SYNCS (7: the step count before and after, the last
     total, make_sched's four λ scalars). It prints the Trainer's
     images_per_sec per epoch, the share of each epoch the loop waits on
     prefetch_to_device, each eval's seconds, the device busy ms and
     launches per Trainer train and eval step (torch.profiler), and the
     Trainer's train step timed alone on one batch (no loader beside it,
     as the step phases time theirs). The card's
     machine has no matplotlib, so the eval's demo grid logs a viz_error;
     it is printed and, as in the JAX package, is no failure
 18. the paper config from a FreiHAND-format tree, through the same entry:
     hifihr_tpu_torch/data/freihand_tree.py writes FREI_TRAIN (480)
     training frames (x 4 colour versions) and FreiHAND's 3,960 evaluation
     frames at 224^2 into a temporary directory (48 frames encoded by
     Pillow at quality 92, the rest hard links), and main() runs
     configs/FreiHAND/full_rhd_freihand.json as it ships (NIMBLE, effb3, 12
     losses, batch 48 and 16, 8 loader threads) with only the tree's path,
     the out dir, controlled_exp/controlled_size 480 (10 steps an epoch),
     total_epochs 2, save_interval 1 (an eval after each epoch) and a
     decode_cache directory moved: epoch 0 decodes the JPEGs and fills the
     cache, epoch 1 reads it; each eval decodes the 3,960 frames. Checks:
     the native warp library loaded and the JPEG decoder named (Pillow
     where libjpeg's header is missing, as on the card's host), each of 8
     frames decoding to the same bytes twice and within
     JPEG_SOURCE_MEAN_ABS levels of its source pixels; a seeded
     augmentation's native warp within 1/255 + 1e-6 of the numpy path;
     both epochs logged, no skipped step,
     every term and eval number finite, no sample substituted, and the
     launches per Trainer train and eval step equal to the paper train and
     eval cells'. It prints decode and warp ms per
     frame (one thread, medians), the loader's batches/s alone (8 threads, decoding and
     cached), images/s and the prefetch wait per epoch, each eval's
     seconds, and device busy ms and launches per Trainer train step

 19. mano_new (the YTBHand baseline), configs/FreiHAND/fully_superv_freihand_mano_new.json
     loaded by Config.from_json: the eval step at its val_batch (16) and
     the train step at its train_batch (64), 224^2, on the flagship batch
     with the config's keys (images, Ks, root_xyz, joints, scales). No TPU
     kernel runs on this path: every kernel's count stays 0. Checks: the
     outputs finite, the encoder's convs in fp32 (the shipped config says
     bfloat16; JAX builds this encoder in fp32), the 2 terms finite and
     not skipped, the parameters changed, a step under
     set_sync_debug_mode("error"); the fp32 steps on the card against the
     CPU at the slice test's size (res50, 32 px, 8 images): eval joints and
     verts 1e-5 m, j2d 1e-3 px; train terms 1e-4, the heads' gradients
     1e-3 relative L2, the encoder's 1e-3 or 20x the CPU's own movement
     under one ulp of input (ResNet-50's backward at random init is ill
     conditioned, tests/test_torch_mano_new.py), 5e-2 at most
 20. mano_new through the entry: hifihr_tpu_torch.train.main on the
     shipped config reading phase 18's FreiHAND-format tree, with only the
     paths, controlled_exp/controlled_size 640 (10 steps of 64),
     total_epochs 1 and save_interval 1 moved: the terms finite, none
     skipped, the eval of the tree's 3,960 frames finished and finite, no
     TPU kernel launched; images/s per epoch and the eval's seconds
 21. NIMBLE's per-fragment UV render (nimble_corner_tex=False, MSAA): the
     eval and train steps at batch 64, 224^2, with the checks of phases 12
     and 13 (the face choice held at 99.5% of pixels, the CPU shading the
     card's), K1, K2 and K3 counted per step (the texture quad's fetch
     among K2's launches, its backward among K3's), and K2 and K3 on the
     texture quad's real forward and backward inputs of one train step
     ((64, 65536, 28) x (64, 50176)): K2 bit-equal, K3 within its bound,
     beside the plain versions, indexing, index_add_ and grid_sample
     (bilinear, border, align_corners=True on 2 uv - 1, the library call
     for the whole sample, held within 1e-5 of sample_texture)
 22. NIMBLE under SSAA (aa_mode="ssaa", batch 8, 672^2, the SSAA cell's
     size): the checks of phases 9 and 10, the CPU step shading the card's
     K4 choice, and K4 held bit-equal to its plain version and timed on the
     step's own NIMBLE hands at step 1 and after the timed steps (beside
     phase 8's tori); K2 and K3 on its texture quad, (8, 65536, 28) x
     (8, 451584)
 23. test-time MANO fitting: configs/smoke_render.json with test_refinement
     through the entry's evaluation (--mode evaluation) on the synthetic
     stand-in: pa_mpjpe_cm and pa_mpjpe_refined_cm finite; one batch's fit
     (151 Adam steps, batch 16) on the card against the CPU (the refined
     joints within 1e-4 m), its ms per fit, device busy ms, launches per
     fit step and host syncs per fit (none); its eval reads 128 samples
     (8 batches), for the script's time limit
 24. dp train (64): the flagship train step over two ranks that share the
     card under gloo (spawned; 32 rows each): K1, K2 and K3 once a step on
     each rank and held against their plain versions on its step-1 inputs,
     15 finite terms, no step skipped, the flat parameters of the ranks bit
     for bit equal after the timed steps; median, images/s of the global
     batch, device busy ms, launches and peak memory per rank; over two
     cards under NCCL (fsdp 1 and 2) where there are two, else "not run"
 25. NCCL at world 1: the flagship train step in a process group of one
     rank under NCCL against the step without one, every collective
     counted: the gradient all-reduce, fed the first run's gradient (K3's
     atomics vary the last bits between runs), returns it bit for bit, and
     the terms, the update and the BatchNorm statistics are bit-equal
 26. 1 rank against 2 (gloo, one card): res18, fp32, 32 px, a global batch
     of 8 varied rows, every ratio term firing (open_2dj, hm_integral,
     texture_self, mrgb_self): step-1 terms and the step-2 total within
     1e-4, step-2 terms within 1e-2, the ranks' parameters bit-equal
 27. rgb2hm (64, 224^2): the flagship plus the stacked-hourglass branch and
     its five losses (kp_cons, hm_integral, hm_integral_gt, open_2dj_de,
     joint_3d_norm) on the flagship batch with seeded openpose
     pseudo-labels: the checks of phases 6-7 (hm_j2d card against CPU
     within 1e-4 of the image size; the hourglass's gradients within 5e-2,
     JAX's own one-ulp move at 32 px, tests/test_torch_rgb2hm.py), and the
     hourglass's device ms and share of each step
 28. configs/smoke_render.json (256 samples a split) through the entry
     at two ranks sharing the card under gloo: one epoch and its eval (K1,
     K2, K3 once a step on each rank; each rank evaluates whole batches),
     rank 0 alone writing; its checkpoint evaluated at one rank and through
     torchrun at two (metrics within 1e-5, and whether equal to the bit),
     and resumed at one rank
 29. hrnet eval (64): the flagship with pretrain="hr18sv2" (HRNet-W18-small-
     v2, 1024 features; no light estimator, as HRNet has no low-level tap):
     the checks of phase 6, and the encoder's device ms and share of the
     step's busy time
 30. hrnet train (64): the checks of phase 7 (K1, K2 and K3 once a step,
     K1 and K3 held on the step's own inputs); the card against the CPU at
     the slice size with HRNet, HRNet's encoder gradients within
     HRNET_GRAD_TOL (its train-mode BatchNorms over few values per channel
     are ill conditioned: tests/test_torch_hrnet_slice.py), the encoder's
     share of the step
 31. four_channel (64): the flagship's eval and train steps with
     four_channel=True, the images carrying the openpose heatmap channel
     (data/freihand.py::keypoint_heatmap_channel of seeded open_2dj), under
     the loss set JAX's step runs with four channels (FOUR_LOSSES: no
     photometric target, as JAX's photometric terms raise on four
     channels); no loss reads the render, so the train step launches K1 and
     K2 and no K3; the checks of phases 6-7 and the card against the CPU at
     32 px
 32. openpose detect (16, 368^2): the CPM hand detector on its 4 scales,
     seeded init; the card against the CPU at 64^2 (peaks equal,
     confidences within 1e-4); images/s, device busy ms and launches per
     batch; no TPU kernel on its path
 33. demo: hifihr_tpu_torch.demo on a PNG the phase writes, restoring a
     checkpoint its CheckpointManager wrote (demo.main whole where
     matplotlib imports, else the demo's own steps and no panel): the OBJ's
     778 vertices and 1538 faces, 8 turntable frames each with a
     silhouette, every frame's K1 route at 2 x 2 subsamples
     (msaa_fine_kernel<2>) exactly equal to msaa_select_plain(...,
     samples=2) and timed against its bound, every K2 launch bit-equal
 34. (right after phase 8) K5, SSIM forward and backward, against its
     plain version (`phase_ssim`) at the flagship's and the paper's call
     shapes and a ragged one; a `{"K5": [...]}` line with its times,
     bounds, the plain version's and the library route's times. Every train
     step holds `ssim.launches` at three per SSIM term

The `{"kernels": [...]}` line also holds every kernel's launches per step
of the new cells (`launches_mano_new_*`, `launches_nimble_uv_*`,
`launches_nimble_ssaa_*`, `launches_trainer_mano_new_*`,
`launches_rgb2hm_*`, `launches_dp_train_step_per_rank`,
`launches_hrnet_*`, `launches_four_channel_*`, `launches_openpose`,
`launches_demo`), K1's 2 x 2 reading on the turntable (`turntable_2x2`), K1's
and K3's on the HRNet and four-channel steps' inputs, K4's readings on
NIMBLE's SSAA hands (`nimble_ssaa_hand`), K1's and K3's on the UV steps'
inputs, and K2's and K3's on the texture quads (`texture_quad_nimble_uv`,
`texture_quad_nimble_ssaa`).

Every step phase prints its median, images/s, device busy ms and launches
per step (torch.profiler over two steps), peak memory and its seconds; the
train steps also the TF32 mode they ran in (off: make_train_step sets full
fp32). Every train step's captured K2 inputs are also held bit-equal to the plain
version, at steps 1 and 41.

Any failed check raises, so the exit code is nonzero; so it is without CUDA.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import statistics
import subprocess
import sys
import time
import re
import warnings

import numpy as np
import torch

B, S = 64, 224
HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 rate outside the tensor cores
# per subsample 3 edge steps + 2 min + 1 compare, + the depth plane: 60 at 3 x 3
def k1_ops_per_pair(samples: int = 3) -> int:
    return 6 * samples * samples + 6
# 15 for the edges, 2 area adds, |area| test, 3 divisions, 3 sign tests,
# 5 for the depth, 1 depth test (csrc/raster_face.cu's inner loop)
K4_OPS_PER_PAIR = 30
SSAA_B, AA = 8, 3  # the SSAA cell: bench.py:278 times it at batch 8
STEPS = 8  # timed steps of each cell
# the bench losses (bench.py:46-49); texture_con and segms_gt in the batch
# add both photometric triples
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "iou", "bone_direc")
FIRED = LOSSES + ("texture_self", "mrgb_self", "ssim_tex_self", "texture", "mrgb", "ssim_tex", "total")
NIMBLE_FACES = 11926
K1_PLAIN_IMAGES = 8  # NIMBLE images K1 is held against its plain version on
# the configuration of tests/test_torch_train_slice.py
# the paper's full-supervision config (NIMBLE, EfficientNet-b3, L1, 12 losses
# with the perceptual one), run as its JSON says at its train and val batches;
# its card-against-CPU check at the slice tests' size
PAPER_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "FreiHAND",
                            "full_rhd_freihand.json")
PAPER_SMALL = dict(image_size=32, light_estimation=False, compute_dtype="float32")
# the batch keys of the config's train queries (images, Ks, joints, scales,
# verts, masks) as the FreiHAND loader names them
PAPER_KEYS = ("imgs", "Ks", "root_xyz", "joints", "verts", "segms_gt", "scales")
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


def paper_batch(batch: dict, n: int) -> dict:
    """The first n images of the flagship batch with the paper config's keys
    and a seeded mask over ~40% of pixels: with the synthetic batch's
    all-zero mask the perceptual loss's composite is the image itself, and
    the term is exactly 0."""
    mask = np.random.RandomState(3).rand(n, S, S) > 0.6
    out = {k: v[:n] for k, v in batch.items() if k in PAPER_KEYS}
    out["segms_gt"] = torch.tensor(mask, dtype=torch.float32, device=batch["imgs"].device)
    return out


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


def walked_pairs(bbox: torch.Tensor, size: int, footprint: tuple = (16, 2)) -> int:
    """(pixel, tested face) pairs a fine kernel walks: a warp tests a
    listed face at its 32 pixels when the face's box touches the warp's
    pixel footprint (16 x 2 in K1's route, 8 x 4 in K4's)."""
    return box_pairs(bbox, size, footprint) * 32


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


# the faces that win on `bin_edge_scene` at 64^2, in K1 and in K4: all but
# 10, which loses the tie to 9
BIN_EDGE_WINNERS = set(range(-1, 13)) - {10}


def torus_scene(size: int, radius: float, seed: int, n: int = SSAA_B) -> tuple:
    """A NIMBLE-sized screen-space scene for K4: a torus of 89 x 67
    vertices, 2 * 89 * 67 = 11,926 faces (NIMBLE's count,
    hifihr_tpu/config.py:201-205), in each of n images under its own seeded
    rotation, so its near and far sides overlap, projected in perspective
    about the image centre; `radius` is the torus's outer radius as a
    share of the image size (`TORUS_RADII`). Returns numpy verts (n, 5963, 3) [u, v, z] and faces
    (11926, 3)."""
    rng = np.random.RandomState(seed)
    nu, nv, R, r = 89, 67, 1.0, 0.4
    th, ph = np.meshgrid(2 * np.pi * np.arange(nu) / nu, 2 * np.pi * np.arange(nv) / nv, indexing="ij")
    ring = R + r * np.cos(ph)
    p = np.stack([ring * np.cos(th), ring * np.sin(th), r * np.sin(ph)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, (i + 1) % nu * nv + j
    c, d = (i + 1) % nu * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3), np.stack([a, c, d], -1).reshape(-1, 3)])
    verts = []
    for _ in range(n):
        q = rng.randn(4)
        w, x, y, z = q / np.linalg.norm(q)  # a uniform random rotation
        rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        q3 = p @ rot.T
        depth = q3[:, 2] + 4.0
        centre = size / 2 + rng.uniform(-0.05, 0.05, 2) * size
        scale = radius * size * 4.0 / (R + r)
        verts.append(np.stack([centre[0] + scale * q3[:, 0] / depth, centre[1] + scale * q3[:, 1] / depth,
                               depth], -1))
    return np.asarray(verts, np.float32), faces.astype(np.int32)


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


ROUTE_PARTS = ("zero_fill", "bin", "fine")  # K1's and K4's routes, one launch each


def route_parts_ms(route, what: str) -> dict:
    """Each launch's device time in one call of a route (zero fill, bin and
    fine kernel) from torch.profiler; a profile that missed every launch of
    one part is taken again."""
    for _ in range(3):
        parts = {}
        for name, (t, _) in device_ms(route).items():
            part = "bin" if "bin" in name else "fine" if "fine" in name else "zero_fill" if "emset" in name else name
            parts[part] = parts.get(part, 0.0) + t
        if set(parts) == set(ROUTE_PARTS):
            break
    check(set(parts) == set(ROUTE_PARTS), f"the profiler saw the route's three launches on {what}: {sorted(parts)}")
    return parts


def launches_per_route(fn, route: str, what: str) -> int:
    """The launches one call of `fn` makes in the route whose counters are
    `<route>.launches` and `<route>.device_launches` (rasterize_msaa for
    K1, rasterize_face_id for K4), as the C route counts them where it
    enqueues each one."""
    from hifihr_tpu_torch.utils.profiling import counters

    before = counters[f"{route}.device_launches"], counters[f"{route}.launches"]
    fn()
    routes = counters[f"{route}.launches"] - before[1]
    check(routes == 1, f"one {what} route per call ({routes})")
    return counters[f"{route}.device_launches"] - before[0]


def k1_route(coef: torch.Tensor, bbox: torch.Tensor, what: str, size: int = S,
             plain_images: int | None = None, samples: int = 3) -> dict:
    """K1's route against its plain version on the prep's records (face_id,
    coverage and zbuf exactly equal; on the first `plain_images` images when
    given, since each image's outputs depend on its own records only), then
    its time on all of them, the launches of one route as the C route counts
    them (a zero fill, the bin kernel and the fine kernel: 3), each launch's
    device time (torch.profiler), the pairs it walks and its bound; at
    `samples` x `samples` subsamples (3 on the model's paths, 2 on the
    turntable's)."""
    from hifihr_tpu_torch.render import raster_msaa as k1

    n = plain_images or coef.shape[0]
    fid, cov, zb = (x[:n] for x in k1.msaa_select_cuda(coef, bbox, size, samples))
    fid_p, cov_p, zb_p = k1.msaa_select_plain(coef[:n], size, samples)
    torch.cuda.synchronize()
    for name, a, b in (("face_id", fid, fid_p), ("coverage", cov, cov_p), ("zbuf", zb, zb_p)):
        check(torch.equal(a, b), f"K1 {name} equals the plain version on {what} "
                                 f"({(a != b).sum().item()} mismatches)")
    covered = (fid_p >= 0).float().mean().item()
    check(covered > 0.01, f"K1 scene covers pixels on {what}")
    route = lambda: k1.msaa_select_cuda(coef, bbox, size, samples)  # noqa: E731
    per_route = launches_per_route(route, "rasterize_msaa", "K1")
    check(per_route == len(ROUTE_PARTS), f"K1's route is a zero fill, a bin and a fine launch on {what}: "
                                      f"{per_route} launches")
    ms = time_ms(route, reps=20)
    parts = route_parts_ms(route, f"K1 on {what}")
    pairs = box_pairs(bbox, size)
    nbytes = (coef.numel() + bbox.numel()) * 4 + 3 * fid.numel() * 4
    bound_ms, bound_by = bound(nbytes, pairs * k1_ops_per_pair(samples))
    out = {"hand": what, "shape": list(coef.shape), "samples": samples, "plain_images": n, "covered": covered,
           "box_pairs": pairs,
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
    """Record the inputs of every K1 route (coef, bbox, size, samples), every K2
    launch (table, idx), every K3 launch (values, idx, n_rows) and every K4
    route (tri, size) the port makes inside the block, by wrapping the
    module functions its wrappers call; the kernels still run, and their
    counts are untouched."""
    from hifihr_tpu_torch.render import gather, raster, raster_msaa

    got = {"K1": [], "K2": [], "K3": [], "K4": []}
    k1_fn, k2_fn, k3_fn, k4_fn = (raster_msaa.msaa_select_cuda, gather._gather, gather._scatter,
                                  raster.select_face_id_cuda)

    def k1(coef, bbox, image_size, samples=3):
        got["K1"].append((coef.clone(), bbox.clone(), image_size, samples))
        return k1_fn(coef, bbox, image_size, samples)

    def k2(table, idx):
        got["K2"].append((table.detach().clone(), idx.clone()))
        return k2_fn(table, idx)

    def k3(values, idx, n_rows):
        got["K3"].append((values.detach().clone(), idx.clone(), n_rows))
        return k3_fn(values, idx, n_rows)

    def k4(tri, image_size):
        got["K4"].append((tri.clone(), image_size))
        return k4_fn(tri, image_size)

    raster_msaa.msaa_select_cuda, gather._gather, gather._scatter, raster.select_face_id_cuda = k1, k2, k3, k4
    try:
        yield got
    finally:
        raster_msaa.msaa_select_cuda, gather._gather, gather._scatter, raster.select_face_id_cuda = (
            k1_fn, k2_fn, k3_fn, k4_fn)


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


def k3_yardsticks(g: torch.Tensor, idx: torch.Tensor, n_rows: int) -> tuple:
    """The plain K3's time and one `index_add_` over the flattened
    (B * n_rows + 1) table, background sent to the extra row (ms)."""
    from hifihr_tpu_torch.render.gather import scatter_rows_plain

    n, _, row = g.shape
    b_idx = torch.arange(n, device=idx.device)[:, None]
    dst = torch.where(idx >= 0, idx.long() + b_idx * n_rows, n * n_rows).reshape(-1)
    g2 = g.reshape(-1, row)
    return (time_ms(lambda: scatter_rows_plain(g, idx, n_rows), reps=20),
            time_ms(lambda: torch.zeros(n * n_rows + 1, row, device=g.device).index_add_(0, dst, g2), reps=20))


def k2_bound(table: torch.Tensor, idx: torch.Tensor) -> tuple:
    """(the distinct rows idx reads, K2's bound): the bytes the work needs
    are those rows of the table, idx and the output, each once."""
    b_idx = torch.arange(table.shape[0], device=idx.device)[:, None]
    rows = torch.unique((idx.long() + b_idx * table.shape[1])[idx >= 0]).numel()
    return rows, bound((rows * table.shape[2] + idx.numel() + idx.numel() * table.shape[2]) * 4)


def k2_reading(table: torch.Tensor, idx: torch.Tensor, what: str, index_select: torch.Tensor | None = None) -> dict:
    """K2 bit-equal to its plain version on one input, then its time, the
    plain version's, one PyTorch indexing call's (`table[b, idx]`, zero rows
    at -1), `index_select` where the index is one list for every image, and
    the bound (`k2_bound`: the rows idx reads, idx, the output)."""
    from hifihr_tpu_torch.render import gather as k2

    out = k2.gather_rows(table, idx)
    ref = k2.gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    check(torch.equal(out.view(torch.int32), ref.view(torch.int32)), f"K2 bit-equal to the plain version on {what}")
    b_idx = torch.arange(table.shape[0], device=idx.device)[:, None]
    rows, (bound_ms, bound_by) = k2_bound(table, idx)
    r = {"input": what, "table": list(table.shape), "idx": list(idx.shape), "rows_read": rows, "max_abs_err": 0.0,
         "ms": time_ms(lambda: k2.gather_rows(table, idx), reps=50),
         "plain_ms": time_ms(lambda: k2.gather_rows_plain(table, idx), reps=20),
         "library_ms": time_ms(lambda: table[b_idx, idx.clamp(min=0).long()] * (idx >= 0)[..., None], reps=20),
         "bound_ms": bound_ms, "bound_by": bound_by}
    if index_select is not None:
        r["index_select_ms"] = time_ms(lambda: table.index_select(1, index_select), reps=20)
    print(f"K2 on {what}: " + json.dumps(r))
    return r


def check_k2_captures(got: list, what: str) -> int:
    """Every captured K2 input of a step bit-equal to the plain version."""
    from hifihr_tpu_torch.render import gather as k2

    for i, (table, idx) in enumerate(got):
        out, ref = k2.gather_rows(table, idx), k2.gather_rows_plain(table, idx)
        check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
              f"K2 launch {i} of {what} ({tuple(table.shape)}) bit-equal to the plain version")
    return len(got)


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
             torch.tensor(edge_faces, device=vs.device).long(), BIN_EDGE_WINNERS),
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
    _, (k2_bound_ms, k2_by) = k2_bound(table, idx)

    # K3 on the render's real backward input
    n_faces, row = table.shape[1], table.shape[2]
    g = l1_render_grad(batch, fid, cov, out)
    k3_eval = k3_launch(g, idx, n_faces, "the MSAA render's backward input, eval hand")
    k3_plain_ms, k3_lib_ms = k3_yardsticks(g, idx, n_faces)
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
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_by, "library_ms": lib_ms},
        {"name": "K3 scatter_rows", "route": "cuda", "source": "hifihr_tpu_torch/csrc/scatter_rows.cu",
         "replaces": "hifihr_tpu/render/gather_mxu.py:87", "launches": None,
         "max_abs_err": k3_eval["max_abs_err"], "ms": k3_eval["ms"], "plain_ms": k3_plain_ms,
         "bound_ms": k3_eval["bound_ms"], "bound_by": k3_eval["bound_by"], "library_ms": k3_lib_ms,
         "eval_hand": k3_eval},
    ]
    return kernels


def nimble_hands(batch: dict, seed: int = 2):
    """64 posed NIMBLE hands: the port's NimbleLayer on numpy-seeded PCA
    pose, shape and appearance, placed as the model places them (the NIMBLE
    root, joint 11, at root_xyz), with the NIMBLE corner renderer (faces,
    atlas corners and corner appearance in Morton order). Returns
    (camera-space verts, albedo, appearance coefficients, renderer)."""
    from hifihr_tpu_torch.hand.nimble import NimbleLayer
    from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings

    dev = batch["Ks"].device
    rng = np.random.RandomState(seed)
    layer = NimbleLayer().to(dev)
    params = {k: torch.tensor(rng.randn(B, n) * 0.5, dtype=torch.float32, device=dev)
              for k, n in (("pose_params", 30), ("shape_params", 20), ("texture_params", 10))}
    out = layer(params)
    verts = out["skin_verts"] - out["nimble_joints"][:, 11:12] + batch["root_xyz"]
    renderer = PhongRenderer(layer.faces_np, layer.v_template_np, RenderSettings(S, AA), face_uv=layer.face_uv_np,
                             corner_mean=layer.corner_mean_np, corner_basis=layer.corner_basis_np).to(dev)
    return verts, out["skin_albedo"], params["texture_params"], renderer


def phase_nimble_kernels(batch: dict) -> dict:
    """K1, K2 and K3 at NIMBLE's shapes on 64 posed NIMBLE hands at 224^2."""
    from hifihr_tpu_torch.render import raster_msaa as k1
    from hifihr_tpu_torch.render.interpolate import pack_face_table
    from hifihr_tpu_torch.render.mesh import vertex_normals_and_tangents
    from hifihr_tpu_torch.render.raster import project_to_screen
    from hifihr_tpu_torch.render.shading import DirectionalLight

    verts, albedo, tex, r = nimble_hands(batch)
    faces, K = r.faces, batch["Ks"]
    vs = project_to_screen(verts, K)
    coef, bbox = k1.msaa_prep(vs, faces)
    check(tuple(coef.shape) == (B, NIMBLE_FACES, 15), f"NIMBLE K1 input shape {tuple(coef.shape)}")
    k1_n = k1_route(coef, bbox, "the NIMBLE hands", plain_images=K1_PLAIN_IMAGES)
    k1_n["plain_ms"] = time_ms(lambda: k1.msaa_select_plain(coef, S), reps=1, groups=1)
    print(f"K1 plain version on the 64 NIMBLE hands: {k1_n['plain_ms']:.2f} ms")

    fid, _, _ = k1.msaa_select_cuda(coef, bbox, S)
    normals, tangents = vertex_normals_and_tangents(verts, faces, r.face_uv)
    table = pack_face_table(vs, faces, torch.cat([tangents, normals], dim=-1), r.corner_appearance(tex))
    idx = fid.reshape(B, S * S).contiguous()
    check(tuple(table.shape) == (B, NIMBLE_FACES, 48), f"NIMBLE packed table shape {tuple(table.shape)}")
    flat = faces.reshape(-1)
    corners = torch.cat([vs, tangents, normals], dim=-1).contiguous()
    cidx = flat.to(torch.int32).expand(B, -1).contiguous()
    k2_n = {"per_pixel_fetch": k2_reading(table, idx, "the NIMBLE packed table"),
            "corner_gather": k2_reading(corners, cidx, "the NIMBLE corner gather", index_select=flat)}

    # K3's real inputs: the backward of an L1 loss on the shaded corner render
    verts_r, tex_r = verts.detach().requires_grad_(), tex.detach().requires_grad_()
    with captured_kernel_inputs() as got:
        rgba = r(verts_r, albedo, K, DirectionalLight.default(B, device=verts.device), tex_coef=tex_r)
        (rgba[..., :3] - batch["imgs"]).abs().mean().backward()
    check(tex_r.grad.abs().sum().item() > 0, "the render's gradient reached the appearance coefficients")
    names = {48: "the NIMBLE render's per-pixel fetch backward", 9: "the NIMBLE packed table's corner gather backward",
             3: "the NIMBLE normals' and tangents' corner gather backward"}
    check(sorted(g.shape[2] for g, _, _ in got["K3"]) == [3, 9, 48],
          f"three K3 launches in the NIMBLE render's backward: {[tuple(g.shape) for g, _, _ in got['K3']]}")
    k3_n = {}
    for g, gidx, n_rows in got["K3"]:
        what = names[g.shape[2]]
        k3_n[what] = k3_launch(g, gidx, n_rows, what)
        k3_n[what]["plain_ms"], k3_n[what]["library_ms"] = k3_yardsticks(g, gidx, n_rows)
    return {"K1": k1_n, "K2": k2_n, "K3": k3_n}


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


K4_FOOTPRINT = (8, 4)  # the pixels one warp of K4's fine kernel covers (u, v)
TORUS_RADII = {"about 12%": 0.26, "about 60%": 0.53}  # torus_scene's radius per covered share


def k4_route(tri: torch.Tensor, size: int, what: str, ref: tuple | None = None) -> dict:
    """K4's route against its plain version (`ref`, computed when not given;
    face_id and zbuf exactly equal), then its time, the launches of one
    route as the C route counts them (a zero fill, the bin kernel and the
    fine kernel: 3), each launch's device time (torch.profiler), the pairs
    its warps walk and its bound."""
    from hifihr_tpu_torch.render import raster as k4

    fid, zb = k4.select_face_id_cuda(tri, size)
    fid_p, zb_p = ref if ref is not None else k4.select_face_id_plain(tri, size)
    torch.cuda.synchronize()
    for name, a, b in (("face_id", fid, fid_p), ("zbuf", zb, zb_p)):
        check(torch.equal(a, b), f"K4 {name} equals the plain version on {what} "
                                 f"({(a != b).sum().item()} mismatches)")
    covered = (fid_p >= 0).float().mean().item()
    check(covered > 0.01, f"K4 scene covers pixels on {what}")
    route = lambda: k4.select_face_id_cuda(tri, size)  # noqa: E731
    per_route = launches_per_route(route, "rasterize_face_id", "K4")
    check(per_route == len(ROUTE_PARTS), f"K4's route is a zero fill, a bin and a fine launch on {what}: "
                                         f"{per_route} launches")
    ms = time_ms(route, reps=20)
    parts = route_parts_ms(route, f"K4 on {what}")
    boxes = face_boxes(tri)
    pairs = box_pairs(boxes, size)
    bound_ms, bound_by = bound(tri.numel() * 4 + 2 * fid.numel() * 4, pairs * K4_OPS_PER_PAIR)
    out = {"input": what, "shape": list(tri.shape), "image_size": size, "covered": covered,
           "box_pairs": pairs, "walked_pairs": walked_pairs(boxes, size, K4_FOOTPRINT),
           "tile_pairs": tile_pairs(boxes, size), "route_ms": ms, "parts_ms": parts,
           "device_ms": sum(parts.values()), "launches_per_route": per_route,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"K4 on {what}: " + json.dumps(out))
    return out


def phase_k4(batch: dict) -> dict:
    from hifihr_tpu_torch.render import raster as k4
    from hifihr_tpu_torch.render.renderer import _scale_intrinsics

    size = S * AA
    verts, _, faces, attrs = posed_meshes(batch)
    verts, attrs = verts[:SSAA_B], attrs[:SSAA_B]
    vs = k4.project_to_screen(verts, _scale_intrinsics(batch["Ks"][:SSAA_B], float(AA)))
    tri = k4.face_triangles(vs, faces)
    check(tuple(tri.shape) == (SSAA_B, 1538, 9), f"K4 input shape {tuple(tri.shape)}")
    fid, zb = k4.rasterize_face_id(vs, faces, size)
    ref = k4.select_face_id_plain(tri, size)
    torch.cuda.synchronize()
    covered = ref[0] >= 0
    print(f"K4: {tuple(fid.shape)}, covered pixels {covered.float().mean().item():.4f}, face_id mismatches "
          f"{(fid != ref[0]).sum().item()}, zbuf mismatches {(zb != ref[1]).sum().item()}")
    check(torch.equal(fid, ref[0]) and torch.equal(zb, ref[1]), "K4 through rasterize_face_id equals the plain "
                                                                "version on the eval hand")
    k4_err = (zb[covered] - ref[1][covered]).abs().max().item()
    eval_hand = k4_route(tri, size, "the eval hand", ref)
    # the route's floor: the eval hand's corners with every depth behind the
    # camera, so no face is listed and every tile writes background
    empty = tri.clone()
    empty[..., 2::3] = -1.0
    efid, ezb = k4.select_face_id_cuda(empty, size)
    check(bool((efid == -1).all()) and bool(torch.isinf(ezb).all()), "K4 writes background where no face is valid")
    no_face = {"route_ms": time_ms(lambda: k4.select_face_id_cuda(empty, size), reps=20),
               "parts_ms": route_parts_ms(lambda: k4.select_face_id_cuda(empty, size), "K4 on no valid face")}
    print("K4 with no valid face (the route's floor): " + json.dumps(no_face))

    # the crafted scenes: K4's edge cases, and the bins' and tiles' edges
    edge_vs, edge_faces = bin_edge_scene()
    cvs, cfaces = crafted_scene(vs.device)
    for what, sv, sf, won in (
            ("K4's crafted scene", cvs, cfaces, {-1, 2, 3, 4}),
            ("the bin-edge scene", torch.tensor(edge_vs, device=vs.device),
             torch.tensor(edge_faces, device=vs.device).long(), BIN_EDGE_WINNERS)):
        got = k4.rasterize_face_id(sv, sf, 64)
        want = k4.rasterize_face_id_plain(sv, sf, 64)
        torch.cuda.synchronize()
        seen = set(torch.unique(got[0]).tolist())
        print(f"K4 on {what} (64^2): faces selected {sorted(seen)}")
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"K4 equals the plain version on {what}")
        check(seen == won, f"K4 on {what}: the faces that win are {sorted(won)}, not {sorted(seen)}")

    # NIMBLE's face count, at two covered shares
    nimble = {}
    for i, (share, radius) in enumerate(TORUS_RADII.items()):
        tv, tf = torus_scene(size, radius, seed=10 + i)
        ttri = k4.face_triangles(torch.tensor(tv, device=vs.device), torch.tensor(tf, device=vs.device).long())
        check(tuple(ttri.shape) == (SSAA_B, 11926, 9), f"NIMBLE-sized K4 input shape {tuple(ttri.shape)}")
        what = f"the NIMBLE-sized torus, {share} covered"
        tref = k4.select_face_id_plain(ttri, size)
        nimble[share] = k4_route(ttri, size, what, tref)

    k4_plain_ms = time_ms(lambda: k4.select_face_id_plain(tri, size), reps=1, groups=2)
    print(f"K4: route {eval_hand['route_ms']:.4f} ms on the eval hand, plain {k4_plain_ms:.2f} ms, "
          f"bound {eval_hand['bound_ms']:.4f} ms ({eval_hand['bound_by']})")

    fetch = ssaa_fetch_times(vs, faces, fid, torch.cat([attrs, verts], dim=-1))
    print("SSAA corner fetch, forward + backward: " + json.dumps(fetch))
    return {"name": "K4 face_raster", "route": "cuda", "source": "hifihr_tpu_torch/csrc/raster_face.cu",
            "replaces": "hifihr_tpu/render/raster_pallas.py:26", "launches": None,
            "max_abs_err": k4_err, "ms": eval_hand["route_ms"], "device_ms": eval_hand["device_ms"],
            "parts_ms": eval_hand["parts_ms"],
            "launches_per_route": eval_hand["launches_per_route"], "plain_ms": k4_plain_ms,
            "bound_ms": eval_hand["bound_ms"], "bound_by": eval_hand["bound_by"], "library_ms": None,
            "eval_hand": eval_hand, "no_valid_face": no_face, "nimble_sized": nimble}


# the kernels each render mode's steps launch; the others must stay at 0
PATH_KERNELS = {"msaa": ("K1 msaa_raster", "K2 gather_rows", "K3 scatter_rows"),
                "ssaa": ("K4 face_raster", "K2 gather_rows", "K3 scatter_rows")}


# K5 at the flagship's two calls a step, the paper's one, and a ragged shape
# (partial tiles on both axes, an image narrower than the window's reach)
SSIM_SHAPES = ((B, S, S, 3), (48, S, S, 3), (5, 37, 101, 3))
# K5 against its plain version, both fp32 (stated before the first run):
# where a region is flat, sigma^2 = E[x^2] - mu^2 cancels, so the last bits
# of the moments (fused multiply-adds in K5, separate roundings in the
# plain version) move S and the partials by up to ~3e-5 relative there; the
# mean over millions of pixels averages that out to well under 1e-6
SSIM_VALUE_TOL = 1e-6  # absolute, on the mean SSIM
SSIM_GRAD_TOL = 1e-4  # relative L2 of dx and dy
SSIM_GRAD_MAX_TOL = 1e-3  # largest entry's error over the largest entry


def ssim_pair(shape: tuple, seed: int) -> tuple:
    """A render-like pair on the card: a smooth colour field (bilinear from
    an eighth of the size) over a seeded disk per image and zeros elsewhere
    (a masked render), and the field with noise over the disk moved 3 px,
    clipped to [0, 1] (its masked target)."""
    b, h, w, c = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    coarse = torch.rand(b, c, max(h // 8, 2), max(w // 8, 2), generator=gen, device="cuda")
    field = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    field = field.permute(0, 2, 3, 1)
    yy = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w)
    cy, cx, r = (torch.rand(3, b, 1, 1, generator=gen, device="cuda")
                 * torch.tensor([h, w, 0.25 * min(h, w)], device="cuda").view(3, 1, 1, 1))
    r = r + 0.15 * min(h, w)

    def disk(dy: float, dx: float) -> torch.Tensor:
        return (((yy - cy - dy) ** 2 + (xx - cx - dx) ** 2) < r**2).float()[..., None]

    noise = 0.05 * torch.randn(shape, generator=gen, device="cuda")
    return (field * disk(0, 0)).contiguous(), ((field + noise).clamp(0, 1) * disk(3, 3)).contiguous()


def ssim_gaps(value, dx, ref_value, ref_dx) -> dict:
    return {"value": abs(value - ref_value).item(), "dx_rel_l2": ((dx - ref_dx).norm() / ref_dx.norm()).item(),
            "dx_max": ((dx - ref_dx).abs().max() / ref_dx.abs().max()).item()}


def phase_ssim() -> None:
    """K5 (SSIM forward and backward) against its plain version on the card
    (`ssim_partials_plain`, fp32) at SSIM_SHAPES: value and dx (and dy)
    within the SSIM_*_TOL; value and dx bit-equal over two calls; the
    value without the partial maps (no_grad) equal to the value with them;
    ssim.launches counting each launch (two a forward, one a backward); a
    raise on bf16 and on non-contiguous images. Both fp32 versions' gaps to
    the plain version in float64. Times by CUDA events, each launch's
    device time, the plain version's and the library route's (the grouped
    F.conv2d of ssim_plain with autograd) beside the bound."""
    from hifihr_tpu_torch.losses.ssim import ssim, ssim_partials_plain, ssim_plain
    from hifihr_tpu_torch.utils.profiling import counters

    t0 = time.perf_counter()
    readings = []
    for i, shape in enumerate(SSIM_SHAPES):
        what = f"K5 at {shape}"
        x, y = ssim_pair(shape, seed=i)
        xg = x.clone().requires_grad_()

        def fwd_bwd(xg=xg, y=y):
            xg.grad = None
            out = ssim(xg, y)
            out.backward()
            return out.detach(), xg.grad

        before = counters["ssim.launches"]
        v1, dx1 = fwd_bwd()
        check(counters["ssim.launches"] - before == 3, f"{what}: three launches for a forward and backward")
        v2, dx2 = fwd_bwd()
        check(torch.equal(v1, v2) and torch.equal(dx1, dx2), f"{what}: value and dx bit-equal over two calls")
        before = counters["ssim.launches"]
        with torch.no_grad():
            v0 = ssim(x, y)
        check(counters["ssim.launches"] - before == 2, f"{what}: two launches for a forward without gradient")
        check(torch.equal(v0, v1), f"{what}: the value without the partial maps is the value with them")
        pv, pdx, _ = ssim_partials_plain(x, y, with_dy=False)
        gaps = ssim_gaps(v1, dx1, pv, pdx)
        tv, tdx, tdy = ssim_partials_plain(x.double(), y.double(), with_dy=True)
        truth = {"kernel": ssim_gaps(v1.double(), dx1.double(), tv, tdx),
                 "plain": ssim_gaps(pv.double(), pdx.double(), tv, tdx)}
        xg2, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        ssim(xg2, yg).backward()
        _, _, pdy = ssim_partials_plain(x, y, with_dy=True)
        gaps["dy_rel_l2"] = ((yg.grad - pdy).norm() / pdy.norm()).item()
        gaps["dy_max"] = ((yg.grad - pdy).abs().max() / pdy.abs().max()).item()
        truth["kernel"]["dy_rel_l2"] = ((yg.grad.double() - tdy).norm() / tdy.norm()).item()
        truth["plain"]["dy_rel_l2"] = ((pdy.double() - tdy).norm() / tdy.norm()).item()
        print(f"{what}: value {v1.item()}, gaps to the fp32 plain version {json.dumps(gaps)}, "
              f"to the float64 plain version {json.dumps(truth)}")
        check(gaps["value"] <= SSIM_VALUE_TOL, f"{what}: value within {SSIM_VALUE_TOL} of the plain version")
        check(max(gaps["dx_rel_l2"], gaps["dy_rel_l2"]) <= SSIM_GRAD_TOL
              and max(gaps["dx_max"], gaps["dy_max"]) <= SSIM_GRAD_MAX_TOL,
              f"{what}: dx and dy within {SSIM_GRAD_TOL} relative L2 and {SSIM_GRAD_MAX_TOL} of the largest entry")
        check(torch.equal(xg2.grad, dx1), f"{what}: dx the same when dy is computed beside it")
        del xg2, yg, pdy, tdx, tdy, pdx

        plane = x.numel()
        fwd_bound = bound(5 * plane * 4, (2 * 5 * 11 * 2 + 3) * plane)  # read x, y; write a, b, c
        bwd_bound = bound(6 * plane * 4, (2 * 3 * 11 * 2 + 6) * plane)  # read x, y, a, b, c; write dx
        with torch.no_grad():
            value_ms = time_ms(lambda: ssim(x, y), reps=20)
        reading = {"shape": list(shape), "gaps": gaps, "float64_gaps": truth,
                   "ms": {"forward": time_ms(lambda: ssim(xg, y), reps=20), "forward_backward": time_ms(fwd_bwd, 20),
                          "forward_no_grad": value_ms},
                   "device_ms": {k: v[0] for k, v in device_ms(fwd_bwd).items()},
                   "bound_ms": {"forward": fwd_bound, "backward": bwd_bound,
                                "forward_no_grad": bound(2 * plane * 4, (2 * 5 * 11 * 2 + 3) * plane)},
                   "plain_ms": time_ms(lambda: ssim_partials_plain(x, y, with_dy=False), reps=3),
                   "library_ms": time_ms(lambda: ssim_plain(xg, y).backward(), reps=5)}
        print(f"{what}: " + json.dumps(reading))
        readings.append(reading)
        del x, y, xg, v0, v1, v2, dx1, dx2

    x = torch.rand(2, 16, 16, 3, device="cuda")
    for bad, exc, why in ((x.bfloat16(), TypeError, "bf16"), (torch.cat([x, x], -1)[..., :3], ValueError,
                                                             "non-contiguous")):
        try:
            ssim(bad, bad)
        except exc as e:
            print(f"K5 raises on {why} images: {e}")
        else:
            check(False, f"K5 raises on {why} images")
    print(json.dumps({"K5": readings}))
    print(f"phase K5 (SSIM): {time.perf_counter() - t0:.1f} s")


def step_config(aa_mode: str = "msaa", hand_model: str = "mano", pretrain: str = "res50"):
    """The flagship steps' configuration (bench.py:52-63): full width and
    depth, the bench losses, Adam at lr 1e-3; `pretrain="effb3"` is bench's
    effb3 cell (bench.py:274-275)."""
    from hifihr_tpu_torch.config import Config

    return Config(pretrain=pretrain, hand_model=hand_model, render=True, light_estimation=True,
                  image_size=S, aa_factor=AA, aa_mode=aa_mode, compute_dtype="bfloat16",
                  losses=LOSSES, optimizer="Adam", init_lr=1e-3)


def phase_eval_step(batch: dict, profile: bool, cfg, path: str, check_cfg, check_batch: dict,
                    check_what: str) -> dict:
    """The eval step of `cfg` on `batch`, its checks and its numbers; the
    same step in fp32 (`check_cfg`) on the card against the CPU on
    `check_batch`."""
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_eval_step

    t0 = time.perf_counter()
    n = batch["imgs"].shape[0]
    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, "FreiHand", cfg)
    step(batch)  # cuDNN autotuning and allocator warm-up
    torch.cuda.synchronize()

    reset_launches()
    out = step(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    check_route_launches(launches, f"the {path} eval step")
    print(f"{path} eval step launches: {launches}")
    raster, gather, scatter = PATH_KERNELS[cfg.aa_mode]
    check(launches[raster] == 1 and launches[gather] > 0 and launches[scatter] == 0
          and sum(launches.values()) == launches[raster] + launches[gather],
          f"the {cfg.aa_mode} rasteriser once, K2, and no backward or other rasteriser on the eval path: {launches}")

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
    print(f"{path} eval step outputs finite; re_sil covers {sil_frac:.4f} of pixels")

    eval_card_vs_cpu(check_cfg, check_batch, check_what)

    torch.cuda.reset_peak_memory_stats()
    numbers = time_steps(lambda: step(batch), n)
    numbers["device_busy_ms"], numbers["launches_per_step"] = device_profile(lambda: step(batch))
    if cfg.rgb2hm:
        numbers["hourglass"] = hourglass_share(model, batch, numbers["device_busy_ms"], False, f"the {path} eval step")
    if cfg.pretrain == "hr18sv2":
        numbers["encoder"] = encoder_share(model, batch, numbers["device_busy_ms"], False, f"the {path} eval step")
    print(f"{path} eval step: " + json.dumps(numbers))
    if profile:
        busy = profile_steps(step, batch)
        if cfg.pretrain == "res50" and cfg.hand_model == "mano" and cfg.aa_mode == "msaa":
            stage_times(model, batch)
        if cfg.pretrain == "effb3":
            encoder_share(model, batch, busy, train=False, what=f"the {path} eval step")
    print(f"phase {path} eval: {time.perf_counter() - t0:.1f} s")
    return launches


def eval_card_vs_cpu(cfg32, batch: dict, what: str) -> None:
    """The fp32 eval step on the card (kernels) against the CPU (plain
    versions) on a host batch."""
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_eval_step

    gpu32 = make_eval_step(build_model(cfg32, device="cuda", seed=0), "FreiHand", cfg32)(
        {k: v.cuda() for k, v in batch.items()})
    cpu32 = make_eval_step(build_model(cfg32, device="cpu", seed=0), "FreiHand", cfg32)(batch)
    diffs = {k: (gpu32[k].cpu() - cpu32[k]).abs().max().item() for k in ("joints", "mano_verts", "j2d", "hm_j2d")
             if k in cpu32}
    # a pixel whose nearest face flips between the two runs (ulp-level
    # geometry differences) differs by a whole colour or depth: count shares
    sil_mismatch = (gpu32["re_sil"].cpu() != cpu32["re_sil"]).float().mean().item()
    off = {k: ((gpu32[k].cpu() - cpu32[k]).abs() > 1e-4).float().mean().item()
           for k in ("re_img", "re_depth")}
    print(f"fp32 {cfg32.hand_model} {cfg32.aa_mode} eval step, card vs CPU ({what}): max abs {diffs}, re_sil mismatch "
          f"share {sil_mismatch}, share off by > 1e-4 {off}")
    check(diffs["joints"] < 1e-5 and diffs["mano_verts"] < 1e-5, "joints and verts within 1e-5 m")
    check(diffs["j2d"] < 1e-3, "j2d within 1e-3 px")
    # the soft-argmax over the (S/4)^2 heatmap cells carries the heatmaps'
    # fp32 differences into uv, about S/4 px times them: hm_j2d within 1e-4
    # of the image size (3.6e-3 px measured at 224^2 on an H100)
    check(diffs.get("hm_j2d", 0.0) < 1e-4 * cfg32.image_size, "hm_j2d within 1e-4 of the image size")
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
    from hifihr_tpu_torch.utils.profiling import counters

    for name in counters:
        counters[name] = 0


def read_launches() -> dict:
    from hifihr_tpu_torch.utils.profiling import counters

    return {"K1 msaa_raster": counters["rasterize_msaa.launches"],
            "K2 gather_rows": counters["gather_rows.launches"],
            "K3 scatter_rows": counters["scatter_rows.launches"],
            "K4 face_raster": counters["rasterize_face_id.launches"]}


def check_route_launches(launches: dict, what: str) -> None:
    """Every K1 and K4 route of the run just read made its three launches,
    as the C routes counted them."""
    from hifihr_tpu_torch.utils.profiling import counters

    for name, route in (("K1 msaa_raster", "rasterize_msaa"), ("K4 face_raster", "rasterize_face_id")):
        made = counters[f"{route}.device_launches"]
        check(made == len(ROUTE_PARTS) * launches[name],
              f"{len(ROUTE_PARTS)} launches in each of the {launches[name]} {name} routes of {what}: {made}")


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


def one_train_step(cfg, batch: dict, device: str, faces: tuple | None = None):
    """One train step of a freshly built model (seed 0) on `device`: the
    loss dict as floats, every parameter's gradient on the host, and the
    step's face choice on the host, MSAA's (face_id, coverage) or NIMBLE's
    SSAA (face_id, zbuf). With `faces` (another run's choice) the step
    renders that choice, and its own is returned."""
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    model = build_model(cfg, device=device, seed=0)
    own = []
    # the MSAA face choice, and NIMBLE's SSAA one (the vertices' last bits
    # move a pixel's nearest face at its 11,926 faces)
    name = {"msaa": "select_faces", "ssaa": "select_faces_ssaa" if cfg.hand_model == "nimble" else None}[cfg.aa_mode]
    if cfg.render and name:
        select = getattr(model.renderer, name)

        def recorded(verts_cam, K):
            fid, other = select(verts_cam, K)
            own.append((fid.cpu(), other.cpu()))
            return (fid, other) if faces is None else (faces[0].to(device), faces[1].to(device))

        setattr(model.renderer, name, recorded)
    state = create_train_state(model, cfg)
    step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    _, d = step(state, {k: v.to(device) for k, v in batch.items()}, make_sched(cfg, 0, device=device))
    return ({k: v.item() for k, v in d.items()},
            {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}, own[0] if own else None)


def zero_in_exact_arithmetic(name: str) -> bool:
    """A bias whose gradient is zero in exact arithmetic, so that two
    devices' rounding noise is all it holds: a Linear bias that feeds a
    train-mode BatchNorm, the last BatchNorm bias of EfficientNet blocks
    1-25, a per-channel constant whose every path ends in a train-mode
    BatchNorm (tests/test_torch_effb3_slice.py), and every conv bias of the
    rgb2hm hourglass, whose every path ends in a train-mode BatchNorm or the
    per-joint softmax (tests/test_torch_rgb2hm.py)."""
    if re.fullmatch(r"rgb2hm\..*(conv\d?|skip|merge_feat\d|merge_hm\d|hm\d)\.bias", name):
        return True
    m = re.fullmatch(r"hand_encoder\.base_fc[01]\.bias|encoder\.backbone\.block(\d+)\.bn2\.bias", name)
    return bool(m) and (m.group(1) is None or int(m.group(1)) >= 1)


def grad_tol(cfg, name: str) -> float:
    """The card-against-CPU bound of one gradient's relative L2 error: 1e-3,
    or where the CPU tests found the step ill conditioned, what they hold
    the port to against JAX: the hourglass's, HRNet's encoder's (its
    train-mode BatchNorms over few values per channel;
    tests/test_torch_hrnet_slice.py: up to 30x JAX's own one-ulp move, 5e-2
    at most) and, with four channels, ResNet's below layer4_0.bn1
    (tests/test_torch_four_channel.py)."""
    if name.startswith("rgb2hm."):
        return HOURGLASS_GRAD_TOL
    if cfg.pretrain == "hr18sv2" and name.startswith("encoder."):
        return HRNET_GRAD_TOL
    if cfg.four_channel and name.startswith(FOUR_CHANNEL_STEM_SIDE):
        return FOUR_CHANNEL_STEM_TOL
    return 1e-3


def phase_train_step(batch: dict, profile: bool, cfg, label: str, fired: tuple, small_cfg,
                     small_batch: dict, path: tuple | None = None) -> tuple:
    """The train step of `cfg` on `batch`: its checks, its numbers, and K1,
    K2, K3 and K4 on its own inputs at step 1 and after the timed steps;
    the same step in fp32 (`small_cfg`) on the card against the CPU on
    `small_batch`. `fired` are the loss terms it must compute; `path` the
    kernels it must launch (PATH_KERNELS[cfg.aa_mode] by default)."""
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state
    from hifihr_tpu_torch.utils.profiling import counters

    t0 = time.perf_counter()
    nimble = cfg.hand_model == "nimble"
    # K1's plain version takes seconds per image batch at NIMBLE's face count
    plain_images = K1_PLAIN_IMAGES if nimble else None
    images = batch["imgs"].shape[0]
    model = build_model(cfg, device="cuda", seed=0)
    state = create_train_state(model, cfg, batch)
    loss_computer = LossComputer(cfg)
    step = make_train_step(model, loss_computer, "FreiHand", cfg)
    sched = make_sched(cfg, 0)
    totals = []
    # the first step renders the seeded init's hand: keep the inputs K1, K2,
    # K3 and K4 get there
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
    check_route_launches(launches, f"the {label} train step")
    totals.append(d["total"])
    print(f"{label} train step launches: {launches}")
    path = path or PATH_KERNELS[cfg.aa_mode]
    check(all(launches[k] > 0 for k in path) and sum(launches[k] for k in path) == sum(launches.values()),
          f"{', '.join(path)} and no other kernel ran on the {label} train path: {launches}")
    ssim_terms = [k for k in ("ssim_tex_self", "ssim_tex") if k in d]
    check(counters["ssim.launches"] == 3 * len(ssim_terms),
          f"K5's three launches for each SSIM term of the {label} train step ({ssim_terms}): "
          f"{counters['ssim.launches']}")
    # K1, K3 and K4 on the step's own inputs, and K2 bit-equal there: the
    # first step's here, freed before the timed steps, and a later step's at
    # the end
    hand = {"K1": [], "K2": 0, "K3": [], "K4": []}

    def kernels_on(got: dict, when: str) -> None:
        check(all(len(got[k]) == launches[name] for k, name in (
            ("K1", "K1 msaa_raster"), ("K2", "K2 gather_rows"), ("K3", "K3 scatter_rows"), ("K4", "K4 face_raster"))),
            f"one capture per K1 route, K2 and K3 launch and K4 route of the {label} train step")
        hand["K1"].extend(k1_route(coef, bbox, f"the {label} train step's hand at {when}", size, plain_images,
                                   samples) for coef, bbox, size, samples in got["K1"])
        hand["K2"] += check_k2_captures(got["K2"], f"the {label} train step at {when}")
        hand["K3"].extend(k3_launch(g, idx, n, f"launch {i} of the {label} train step at {when}")
                          for i, (g, idx, n) in enumerate(got["K3"]))
        hand["K4"].extend(k4_route(tri, size, f"the {label} train step's hand at {when}")
                          for tri, size in got["K4"])
        for v in got.values():
            v.clear()

    kernels_on(first, "step 1")
    losses = {k: v.item() for k, v in d.items()}
    print(f"{label} train step losses: " + json.dumps(losses))
    check(set(losses) == set(fired) | {"total", "skipped"},
          f"the {len(fired)} terms, total and skipped: {sorted(losses)}")
    check(all(np.isfinite(v) for v in losses.values()), "loss terms finite")
    check(losses["skipped"] == 0.0, "the step was not skipped")
    changed = (state.optimizer.flat != before).float().mean().item()
    print(f"{label} train step changed {changed:.4f} of the {before.numel()} trained parameters")
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
    print(f"{label} train step: one step ran under set_sync_debug_mode('error'), no host sync")
    for _ in range(10 - len(totals)):
        state, d = step(state, batch, sched)
        totals.append(d["total"])
    trajectory = [t.item() for t in totals]
    print(f"{label} train loss trajectory (10 steps): " + json.dumps(trajectory))
    check(all(np.isfinite(trajectory)) and int(state.step) == 10, f"10 updates taken ({int(state.step)})")

    # fp32 on the card (kernels) against fp32 on the CPU (plain versions), in
    # a small configuration. At the flagship's (res50, 224^2, random init)
    # one ulp of input moves the CPU's own encoder gradients by 3%, so no
    # tighter bound could hold there (ROADMAP.md section 3). The MSAA CPU
    # steps shade the card's face choice, and their own choice is held
    # apart (the module docstring, phases 13 and 16): the vertices' last
    # bits move a few pixels' nearest face (effb3 at 64 px: 11 of 32,768;
    # res18 at 32 px from flax's conv init), and such a pixel moves
    # vert_tex's gradient by 1-2%
    gl, gg, gfaces = one_train_step(small_cfg, small_batch, "cuda")
    cl, cg, cfaces = one_train_step(small_cfg, small_batch, "cpu", gfaces)
    if gfaces is not None:
        same = (gfaces[0] == cfaces[0]).float().mean().item()
        print(f"fp32 {label} train step ({small_cfg.pretrain}, {small_cfg.image_size} px): the CPU's own face "
              f"choice is the card's at {same} of pixels")
        check(same >= 0.995, "the CPU's own face choice agrees with the card's")
    check(set(gl) == set(cl), "the same terms fire on the card and the CPU")
    term_err = {k: abs(gl[k] - cl[k]) / max(abs(cl[k]), 1e-30) for k in cl if k != "skipped"}
    grad_err = {}
    for name, ref in cg.items():
        if zero_in_exact_arithmetic(name):
            continue
        nr = ref.norm().item()
        grad_err[name] = (gg[name] - ref).norm().item() / nr if nr > 0 else gg[name].norm().item()
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:4]
    print(f"fp32 {label} train step ({small_cfg.pretrain}, {small_cfg.image_size} px), card vs CPU on "
          f"{small_batch['imgs'].shape[0]} images: worst loss term rel err "
          f"{max(term_err.items(), key=lambda kv: kv[1])}, worst gradient rel L2 {worst}")
    check(max(term_err.values()) <= 1e-4, "loss terms within 1e-4 of the CPU plain path")
    over = {k: v for k, v in grad_err.items() if v > grad_tol(small_cfg, k)}
    check(not over, f"gradients within 1e-3 relative L2 of the CPU plain path (grad_tol where the CPU tests "
                    f"found the step ill conditioned): {over}")

    torch.cuda.reset_peak_memory_stats()
    numbers = time_steps(lambda: step(state, batch, sched), images)
    numbers["device_busy_ms"], numbers["launches_per_step"] = device_profile(lambda: step(state, batch, sched))
    numbers["tf32"] = {"cudnn": torch.backends.cudnn.allow_tf32, "matmul": torch.backends.cuda.matmul.allow_tf32}
    if cfg.rgb2hm:
        numbers["hourglass"] = hourglass_share(model, batch, numbers["device_busy_ms"], True, f"the {label} train step")
    if cfg.pretrain == "hr18sv2":
        numbers["encoder"] = encoder_share(model, batch, numbers["device_busy_ms"], True, f"the {label} train step")
    print(f"{label} train step: " + json.dumps(numbers))
    if profile:
        busy = profile_steps(lambda b: step(state, b, sched), batch)
        if cfg.pretrain == "effb3":
            encoder_share(model, batch, busy, train=True, what=f"the {label} train step")
        if loss_computer.vgg is not None:
            vgg_share(loss_computer, batch, busy, f"the {label} train step")

    # a step after the timed ones, whose hand the updates have grown
    with captured_kernel_inputs() as later:
        state, _ = step(state, batch, sched)
    kernels_on(later, f"step {int(state.step)}")
    print(f"phase {label} train: {time.perf_counter() - t0:.1f} s")
    return launches, hand


def device_profile(fn, reps: int = 2) -> tuple:
    """(device ms, device launches) per call of `fn`: the sums of every
    kernel's, memset's and copy's device time and count (torch.profiler)
    over `reps` calls after one warm-up, over reps. The profiler can miss a
    launch, so the count reads low if anything; K1's and K4's launches are
    counted in C instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in rows) / reps / 1e3, sum(e.count for e in rows) / reps


def encoder_share(model, batch: dict, busy_ms: float, train: bool, what: str) -> dict:
    """The encoder's backbone alone on the step's images (forward, and the
    backward of its outputs' mean when `train`), in the port's channels-last
    layout and in plain NCHW: device ms (torch.profiler) and CUDA-events ms,
    and the channels-last device ms as a share of the step's device busy
    time."""
    import copy

    from hifihr_tpu_torch.networks.resnet import normalize_imagenet

    imgs = batch["imgs"]
    times = {}
    for layout, fmt in (("channels_last", torch.channels_last), ("nchw", torch.contiguous_format)):
        enc = copy.deepcopy(model.encoder).to(memory_format=fmt).train(train)

        def run():
            with torch.set_grad_enabled(train), model._encoder_autocast(imgs.device):
                x = normalize_imagenet(imgs).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
                out = enc.backbone(x)
            if train:  # HRNet's backbone returns its head's map alone
                sum(t.float().mean() for t in (out if isinstance(out, tuple) else (out,))).backward()

        times[layout] = {"device_ms": device_profile(run)[0], "events_ms": time_ms(run, reps=5)}
        del enc
    share = times["channels_last"]["device_ms"] / busy_ms
    print(f"{model.config.pretrain} encoder on {what}'s {imgs.shape[0]} images "
          f"({'forward + backward' if train else 'forward'}): "
          f"{json.dumps(times)}; channels_last is {share:.3f} of the step's {busy_ms:.3f} ms of device time")
    return dict(times, share=share)


def vgg_share(loss_computer, batch: dict, busy_ms: float, what: str) -> None:
    """The perceptual loss alone (the frozen VGG19 features of the composite
    and of the image, the backward to the composite) on the step's images:
    device ms (torch.profiler) and CUDA-events ms, and its share of the
    step's device busy time."""
    from hifihr_tpu_torch.losses.perceptual import perceptual_loss

    imgs = batch["imgs"]
    composite = (imgs * 0.5).requires_grad_()

    def run():
        perceptual_loss(loss_computer.vgg, composite, imgs).backward()

    dev = device_profile(run)[0]
    print(f"perceptual loss (VGG19 to relu3_2, fp32, cuDNN TF32 {torch.backends.cudnn.allow_tf32}) on {what}'s "
          f"{imgs.shape[0]} images, forward + backward: {dev:.3f} ms of device time "
          f"({time_ms(run, reps=5):.3f} ms by events), {dev / busy_ms:.3f} of the step's {busy_ms:.3f} ms")


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


def profile_steps(step, batch, n: int = 3) -> float:
    """A torch.profiler pass over n steps: wall and device busy ms per step,
    launches, and the kernels ranked by device time. Returns the device busy
    ms per step."""
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
    ours = ("msaa_", "gather_rows", "scatter_rows", "face_", "Memset")  # the port's kernels
    for i, e in enumerate(ranked):
        if i < 25 or any(k in e.key for k in ours):
            print(f"  {e.self_device_time_total / n / 1e3:9.4f} ms/step  x{e.count // n:<4d} {e.key[:110]}")
    return dev_total / n / 1e3


SMOKE_RENDER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "smoke_render.json")
# phase 17's allowance of host syncs in one Trainer epoch beside its print
# points: the step count read before the epoch and after it, the last total
# read after it, and make_sched's four λ scalars (each a copy from pageable
# host memory to the card, which makes the host wait)
TRAINER_EPOCH_SYNCS = 7


def _smoke_render_copy(directory: str, name: str, **over) -> str:
    """configs/smoke_render.json as it ships, with its base_out_path (and
    `over`) pointed into `directory`."""
    with open(SMOKE_RENDER) as f:
        raw = json.load(f)
    raw.update(base_out_path=os.path.join(directory, name), **over)
    path = os.path.join(directory, f"{name}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _read_log(out_dir: str) -> list:
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@contextlib.contextmanager
def trainer_probes(record: dict):
    """Wrap the Trainer's epoch, its eval and its prefetch for the duration:
    per train epoch the kernels' launches (counted from 0 at its start),
    the steps, the seconds and the seconds the loop waited on
    prefetch_to_device; per eval its launches, batches and seconds; and the
    Trainer itself. In `record["sync_epochs"]`'s epochs the epoch runs under
    set_sync_debug_mode("warn"), and its synchronising calls are listed;
    `record["check_start"]` (epoch -> fn(trainer)) runs before an epoch."""
    from hifihr_tpu_torch.training import loop

    orig_prefetch, orig_epoch, orig_eval = loop.prefetch_to_device, loop.Trainer.train_epoch, loop.Trainer.evaluate
    wait = [0.0, 0]

    def prefetch(loader, device, *a, **kw):
        it = orig_prefetch(loader, device, *a, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            wait[0] += time.perf_counter() - t0
            wait[1] += 1
            yield batch

    def train_epoch(self, epoch):
        record["trainer"] = self
        if epoch in record.get("check_start", {}):
            record["check_start"][epoch](self)
        wait[:] = [0.0, 0]
        reset_launches()
        t0 = time.perf_counter()
        if epoch in record.get("sync_epochs", ()):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    rec = orig_epoch(self, epoch)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            record.setdefault("syncs", {})[epoch] = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                                                      if "called a synchronizing" in str(w.message)]
        else:
            rec = orig_epoch(self, epoch)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        check_route_launches(launches, f"the Trainer's epoch {epoch}")
        record.setdefault("epochs", {})[epoch] = {"launches": launches, "steps": wait[1], "seconds": seconds,
                                                  "prefetch_wait_s": wait[0]}
        return rec

    def evaluate(self, epoch=-1):
        reset_launches()
        t0 = time.perf_counter()
        result = orig_eval(self, epoch)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        check_route_launches(launches, f"the Trainer's eval at epoch {epoch}")
        batches = -(-len(self.val_loader.dataset) // self.val_loader.batch_size)
        record.setdefault("evals", {})[epoch] = {"launches": launches, "batches": batches, "seconds": seconds}
        return result

    loop.prefetch_to_device, loop.Trainer.train_epoch, loop.Trainer.evaluate = prefetch, train_epoch, evaluate
    try:
        yield record
    finally:
        loop.prefetch_to_device, loop.Trainer.train_epoch, loop.Trainer.evaluate = (orig_prefetch, orig_epoch,
                                                                                     orig_eval)


def trainer_step_launches(run: dict, key: str, cell_launches: dict, cell: str) -> dict:
    """The kernels' launches per Trainer train step and eval step of a
    `trainer_probes` record, under `{key}train_step` and `{key}eval_step`:
    the same in every epoch and eval, and equal to the step cell's
    (`cell_launches[f"{cell}train_step"]`, ...)."""
    per_step = {}
    for step, runs, count in (("train_step", run["epochs"], "steps"), ("eval_step", run["evals"], "batches")):
        per = {k: {r["launches"][k] / r[count] for r in runs.values()} for k in run["epochs"][0]["launches"]}
        check(all(len(v) == 1 and next(iter(v)).is_integer() for v in per.values()),
              f"the same launches in every {key}{step}: {per}")
        per_step[key + step] = {k: int(next(iter(v))) for k, v in per.items()}
        check(per_step[key + step] == cell_launches[cell + step],
              f"the Trainer's {key}{step} launches the {cell or 'MANO '}{step} cell's kernels: "
              f"{per_step[key + step]} vs {cell_launches[cell + step]}")
    return per_step


def phase_trainer(cell_launches: dict) -> dict:
    """Phase 17: `python -m hifihr_tpu_torch.train --config_json
    configs/smoke_render.json` in-process on the card (hifihr_tpu_torch.train.main),
    its out dir in a temporary directory, then a resume of its checkpoint.
    Returns the launches per Trainer train step and eval step."""
    import tempfile

    from hifihr_tpu_torch import train as entry
    from hifihr_tpu_torch.data.pipeline import prefetch_to_device
    from hifihr_tpu_torch.training.steps import make_sched

    t0 = time.perf_counter()
    with open(SMOKE_RENDER) as f:
        shipped = json.load(f)
    with tempfile.TemporaryDirectory(prefix="hifihr_trainer_") as tmp:
        # run 1: the shipped config, two epochs, an eval after each
        with trainer_probes({}) as run1:
            entry.main(["--config_json", _smoke_render_copy(tmp, "run1")])
        out1 = os.path.join(tmp, "run1")
        log = _read_log(out1)
        epochs = [r for r in log if "train_loss" in r]
        for r in log:
            if "viz_error" in r:
                print(f"trainer viz_error (logged, not a failure, as in the JAX package): {r['viz_error']}")
        check([r["epoch"] for r in epochs] == list(range(shipped["total_epochs"])),
              f"train_log.jsonl holds both epochs: {[r['epoch'] for r in epochs]}")
        check(all(r["skipped_steps"] == 0 for r in epochs), f"no skipped step: {epochs}")
        steps = [r for r in log if "step" in r]
        check(steps and all(np.isfinite(v) for r in steps for k, v in r.items() if isinstance(v, float)),
              "every logged term finite")
        check(epochs[1]["train_loss"] < epochs[0]["train_loss"],
              f"epoch 1's train_loss below epoch 0's: {[r['train_loss'] for r in epochs]}")
        evals = [r["eval"] for r in log if "eval" in r]
        check(len(evals) == len(epochs), f"one eval per saved epoch: {len(evals)}")
        for ev in evals:
            keys = ("pa_mpjpe_cm", "pa_mpvpe_cm", "pck_auc", "tex_psnr", "tex_ssim", "tex_l1", "tex_l2")
            lpips = [k for k in ev if k.startswith("tex_lpips")]
            check(all(np.isfinite(ev.get(k, np.nan)) for k in keys) and len(lpips) == 1
                  and np.isfinite(ev[lpips[0]]), f"eval metrics finite: {ev}")
        ckpt = os.path.join(out1, "model", "texturehand_latest.pt")
        check(os.path.exists(ckpt), "texturehand_latest.pt written")
        for e, rec in run1["epochs"].items():
            print(f"trainer epoch {e}: " + json.dumps(rec))
        for e, rec in run1["evals"].items():
            print(f"trainer eval at epoch {e}: " + json.dumps(rec))
        per_step = trainer_step_launches(run1, "trainer_", cell_launches, "")
        print("trainer launches per step: " + json.dumps(per_step))

        # run 2: resume from run 1's model/ dir for a third epoch, under
        # set_sync_debug_mode("warn"); the restored state must be the saved
        # file's, bit for bit, and Adam's count continue
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        steps_per_epoch = shipped["controlled_size"] // shipped["train_batch"]

        def restored_equals_saved(trainer):
            opt = trainer.state.optimizer
            sd = trainer.model.state_dict()
            check(sd.keys() == saved["model"].keys()
                  and all(torch.equal(sd[k].cpu(), v) for k, v in saved["model"].items()),
                  "the restored parameters and BatchNorm stats equal the saved file")
            check(torch.equal(opt.mu.cpu(), saved["optimizer"]["mu"]) and torch.equal(opt.nu.cpu(), saved["optimizer"]["nu"]),
                  "the restored Adam moments equal the saved file")
            check(int(opt.count) == 2 * steps_per_epoch, f"Adam's count continues at {int(opt.count)}")
            print(f"trainer resume: state restored bit for bit, Adam's count {int(opt.count)} at epoch 2")

        with trainer_probes({"sync_epochs": (2,), "check_start": {2: restored_equals_saved}}) as run2:
            entry.main(["--config_json", _smoke_render_copy(
                tmp, "run2", pretrain_model=os.path.join(out1, "model"), total_epochs=3)])
        log2 = _read_log(os.path.join(tmp, "run2"))
        check([r["epoch"] for r in log2 if "train_loss" in r] == [2], "the resumed run trains epoch 2 only")
        check(int(run2["trainer"].state.step) == 3 * steps_per_epoch, "Adam's count after epoch 2")
        syncs = run2["syncs"][2]
        prints = -(-steps_per_epoch // shipped.get("print_freq", 100))
        print(f"trainer epoch 2 under set_sync_debug_mode('warn'): {len(syncs)} synchronising calls "
              f"({prints} print points + at most {TRAINER_EPOCH_SYNCS}): {syncs}")
        check(len(syncs) <= prints + TRAINER_EPOCH_SYNCS, "host syncs in one epoch within the allowance")

        # the Trainer's own cached steps: device busy and launches per step
        trainer = run2["trainer"]
        batches = prefetch_to_device(trainer.train_loader, trainer.device)
        batch = next(batches)
        batches.close()
        batch.pop("dataset")
        train_step, eval_step = trainer._step_for("FreiHand", True), trainer._step_for("FreiHand", False)
        sched = make_sched(trainer.config, 2, trainer.device)
        numbers = {}
        numbers["train_device_busy_ms"], numbers["train_launches_per_step"] = device_profile(
            lambda: train_step(trainer.state, batch, sched))
        numbers["eval_device_busy_ms"], numbers["eval_launches_per_step"] = device_profile(lambda: eval_step(batch))
        # the same train step on one batch, no loader running beside it
        alone = time_steps(lambda: train_step(trainer.state, batch, sched), batch["imgs"].shape[0])
        numbers["train_step_alone"] = {k: alone[k] for k in ("median_ms", "back_to_back_ms")}
        for e, rec in sorted({**run1["epochs"], **run2["epochs"]}.items()):
            rec_log = next(r for r in (log if e < 2 else log2) if r.get("epoch") == e and "train_loss" in r)
            numbers[f"epoch{e}"] = {"images_per_sec": rec_log["images_per_sec"], "train_loss": rec_log["train_loss"],
                                    "seconds": rec["seconds"], "prefetch_wait_s": rec["prefetch_wait_s"],
                                    "prefetch_wait_share": rec["prefetch_wait_s"] / rec["seconds"]}
        numbers["eval_seconds"] = [r["seconds"] for r in run1["evals"].values()] + [
            r["seconds"] for r in run2["evals"].values()]
        numbers["eval"] = evals[-1]
        print("trainer (smoke_render): " + json.dumps(numbers))
    print(f"phase trainer: {time.perf_counter() - t0:.1f} s")
    return per_step


# phase 18: the paper config trains from a FreiHAND-format tree: FreiHAND's
# 3,960 evaluation frames and FREI_TRAIN training frames (controlled_size, 10
# steps of 48), FREI_DISTINCT of them encoded and the rest hard links
FREI_TRAIN, FREI_EVAL, FREI_DISTINCT = 480, 3960, 48
# phase 20 (mano_new through the entry) reads the same tree: 10 steps of 64
MANO_NEW_TRAIN = 640
# the tree's training frames: the phases read its first FREI_TRAIN and
# MANO_NEW_TRAIN (FreiHAND's loader indexes frames below its 32,560)
FREI_TREE_TRAIN = max(FREI_TRAIN, MANO_NEW_TRAIN)
# the warp check: the native warp's float output against the numpy path's
WARP_TOL = 1 / 255 + 1e-6
# the decode check against the frames' numpy source pixels (Pillow's
# encoder at quality 92, 4:2:0): mean |delta| in levels; the decode reads
# ~1.27 levels on these frames on an H100's host
JPEG_SOURCE_MEAN_ABS = 2.0


def _paper_tree_copy(directory: str, tree: str, cache: str) -> str:
    """configs/FreiHAND/full_rhd_freihand.json as it ships, with the fields
    that point it at the tree and a temporary directory moved, two epochs of
    controlled_size frames, and an eval after each (save_interval 1: the
    shipped 10 would save and evaluate only at epoch 9)."""
    with open(PAPER_CONFIG) as f:
        raw = json.load(f)
    raw.update(freihand_base_path=tree, base_out_path=os.path.join(directory, "out"), controlled_exp=True,
               controlled_size=FREI_TRAIN, total_epochs=2, save_interval=1, decode_cache=cache)
    path = os.path.join(directory, "paper_tree.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def check_tree_frames(tree: str, src: dict) -> dict:
    """On the tree's first 8 training frames: each decodes to the same bytes
    in two calls and within JPEG_SOURCE_MEAN_ABS levels of its source
    pixels; a seeded FreiHAND augmentation's native warp within
    WARP_TOL of the numpy path. Returns the decode and warp ms per frame
    (one thread, medians over the 48 distinct frames)."""
    from hifihr_tpu_torch.data import native
    from hifihr_tpu_torch.geometry import crops

    name = native.decoder()
    aug = np.random.RandomState(0)
    worst = {"source_mean_abs": 0.0, "warp_max_abs": 0.0}
    for i in range(8):
        with open(os.path.join(tree, "training", "rgb", "%08d.jpg" % i), "rb") as f:
            data = f.read()
        px = native.decode_jpeg(data)
        check(px.tobytes() == native.decode_jpeg(data).tobytes(), f"frame {i} decodes to the same bytes twice")
        d = float(np.abs(px.astype(np.float64) - src["images"][i % FREI_DISTINCT]).mean())
        worst["source_mean_abs"] = max(worst["source_mean_abs"], d)
        check(d <= JPEG_SOURCE_MEAN_ABS, f"frame {i} within {JPEG_SOURCE_MEAN_ABS} levels of its source: {d}")
        aff, _ = crops.get_affine_transform(np.asarray([112, 112]), 224, [224, 224],
                                            rot=aug.uniform(-np.pi, np.pi))
        native_px = crops.transform_img(px, aff, [224, 224])
        numpy_px = crops.transform_img(px.astype(np.float32) / 255.0, aff, [224, 224])
        w = float(np.abs(native_px - numpy_px).max())
        worst["warp_max_abs"] = max(worst["warp_max_abs"], w)
        check(w <= WARP_TOL, f"frame {i}: the native warp within {WARP_TOL} of the numpy path: {w}")
    print("tree frames checked (worst of 8): " + json.dumps(worst))
    frames = []
    for i in range(FREI_DISTINCT):
        with open(os.path.join(tree, "training", "rgb", "%08d.jpg" % i), "rb") as f:
            frames.append(f.read())
    decoded = [native.decode_jpeg(d) for d in frames]
    aff, _ = crops.get_affine_transform(np.asarray([112, 112]), 224, [224, 224], rot=0.6)
    mask = (src["masks"][0] >= 128).astype(np.uint8) * 255
    it = iter(range(10**9))
    return {"decoder": name,
            "decode_ms": _median_ms(lambda: native.decode_jpeg(frames[next(it) % FREI_DISTINCT]), 200),
            "warp_ms": _median_ms(lambda: crops.transform_img(decoded[next(it) % FREI_DISTINCT], aff, [224, 224],
                                                              out_u8=True), 200),
            "mask_warp_ms": _median_ms(lambda: crops.transform_img(mask, aff, [224, 224], out_u8=True), 200),
            **worst}


def loader_alone(tree: str, cache: str, queries: tuple, batch: int, workers: int) -> dict:
    """The paper config's train loader over the tree (controlled_size
    frames, its queries, batch and threads), with no step beside it:
    batches/s in an epoch that decodes and fills a decoded-frame cache, and
    in one that reads it."""
    from hifihr_tpu_torch.data.base import BatchLoader, Subset
    from hifihr_tpu_torch.data.freihand import FreiHand

    loader = BatchLoader(Subset(FreiHand(tree, queries=queries, decode_cache=cache), FREI_TRAIN), batch,
                         num_workers=workers)
    out = {}
    for epoch in ("decode", "cached"):
        t0 = time.perf_counter()
        n = sum(1 for _ in loader)
        out[f"{epoch}_batches_per_s"] = n / (time.perf_counter() - t0)
    return out


class _Substitutions(logging.Handler):
    """Counts the BatchLoader's "substituting" warnings (a sample that
    failed to load, served by another)."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        if "substituting" in record.getMessage():
            self.messages.append(record.getMessage())


def phase_real_data(cell_launches: dict) -> dict:
    """Phase 18: `python -m hifihr_tpu_torch.train` in-process on the card
    (hifihr_tpu_torch.train.main) on the paper config, reading a
    FreiHAND-format tree written into a temporary directory. Returns the
    launches per Trainer train step and eval step."""
    import tempfile

    from hifihr_tpu_torch import train as entry
    from hifihr_tpu_torch.data import native
    from hifihr_tpu_torch.data.freihand_tree import write_freihand_tree
    from hifihr_tpu_torch.data.pipeline import prefetch_to_device
    from hifihr_tpu_torch.training.steps import make_sched

    t0 = time.perf_counter()
    with open(PAPER_CONFIG) as f:
        shipped = json.load(f)
    with tempfile.TemporaryDirectory(prefix="hifihr_freihand_") as tmp:
        tree = os.path.join(tmp, "freihand")
        t = time.perf_counter()
        src = write_freihand_tree(tree, FREI_TREE_TRAIN, FREI_EVAL, distinct=FREI_DISTINCT, seed=0)
        print(f"FreiHAND-format tree: {FREI_TREE_TRAIN} training frames x 4 versions, {FREI_EVAL} evaluation "
              f"frames, {FREI_DISTINCT} encoded (Pillow, quality 92), written in {time.perf_counter() - t:.2f} s")
        built = native.available()
        check(os.path.dirname(built["warp"]) == native.BUILD_DIR, f"the native warp library is loaded: {built}")
        print(f"native warp library: {built['warp']}")
        print(f"JPEG decoder: {built['decoder']}")
        numbers = {"frames": check_tree_frames(tree, src)}
        numbers["loader_alone"] = loader_alone(tree, os.path.join(tmp, "cache_alone"),
                                               tuple(shipped["train_queries"]), shipped["train_batch"],
                                               shipped["num_workers"])
        print("real-data loader: " + json.dumps(numbers))

        subs = _Substitutions()
        logging.getLogger().addHandler(subs)
        try:
            with trainer_probes({}) as run:
                entry.main(["--config_json", _paper_tree_copy(tmp, tree, os.path.join(tmp, "cache"))])
        finally:
            logging.getLogger().removeHandler(subs)
        check(not subs.messages, f"no sample substituted: {subs.messages[:3]}")
        log = _read_log(os.path.join(tmp, "out"))
        epochs = [r for r in log if "train_loss" in r]
        check([r["epoch"] for r in epochs] == [0, 1], f"train_log.jsonl holds both epochs: {epochs}")
        check(all(r["skipped_steps"] == 0 for r in epochs), f"no skipped step: {epochs}")
        steps = [r for r in log if "step" in r]
        check(steps and all(np.isfinite(v) for r in steps for k, v in r.items() if isinstance(v, float)),
              "every logged term finite")
        evals = [r["eval"] for r in log if "eval" in r]
        check(len(evals) == 2, f"an eval after each epoch: {len(evals)}")
        for ev in evals:
            nums = {k: v for k, v in ev.items() if isinstance(v, float)}
            check(nums and all(np.isfinite(v) for v in nums.values()), f"eval record finite: {ev}")
        for r in log:
            if "viz_error" in r:
                print(f"trainer viz_error (logged, not a failure, as in the JAX package): {r['viz_error']}")
        trainer = run["trainer"]
        check(len(trainer.val_loader.dataset) == FREI_EVAL and len(trainer.train_loader) == FREI_TRAIN // 48,
              "the eval covers FreiHAND's 3,960 frames and an epoch is 10 steps")
        per_step = trainer_step_launches(run, "trainer_paper_", cell_launches, "paper_")
        print("trainer (paper, FreiHAND tree) launches per step: " + json.dumps(per_step))

        batches = prefetch_to_device(trainer.train_loader, trainer.device)
        batch = next(batches)
        batches.close()
        batch.pop("dataset")
        train_step = trainer._step_for("FreiHand", True)
        sched = make_sched(trainer.config, 1, trainer.device)
        numbers["train_device_busy_ms"], numbers["train_launches_per_step"] = device_profile(
            lambda: train_step(trainer.state, batch, sched))
        for e, rec in sorted(run["epochs"].items()):
            rec_log = next(r for r in log if r.get("epoch") == e and "train_loss" in r)
            numbers[f"epoch{e}"] = {"images_per_sec": rec_log["images_per_sec"], "train_loss": rec_log["train_loss"],
                                    "seconds": rec["seconds"], "prefetch_wait_s": rec["prefetch_wait_s"],
                                    "prefetch_wait_share": rec["prefetch_wait_s"] / rec["seconds"]}
        numbers["eval_seconds"] = [r["seconds"] for r in run["evals"].values()]
        numbers["eval"] = evals[-1]
        print("trainer (paper, FreiHAND tree): " + json.dumps(numbers))
        print(f"phase real data: {time.perf_counter() - t0:.1f} s")
        per_step.update(phase_mano_new_entry(tmp, tree))
    return per_step


# phases 19-23: the model variants of the last slice. mano_new (the YTBHand
# baseline) as it ships, at its own val and train batches
MANO_NEW_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "FreiHAND",
                               "fully_superv_freihand_mano_new.json")
# its batch keys: the config's train queries (images, Ks, joints, scales) and root_xyz
MANO_NEW_KEYS = ("imgs", "Ks", "root_xyz", "joints", "scales")
MANO_NEW_HEADS = ("theta_fc0.weight", "theta_fc0.bias", "theta_fc1.weight", "theta_fc1.bias", "encoder.mmpool.p")
# the encoder's gradients on the card against the CPU: within 1e-3, or 20x
# the CPU's own movement under one ulp of input where that is larger (ResNet-50's
# train-mode backward at random init is ill conditioned: tests/test_torch_mano_new.py),
# and MANO_NEW_GRAD_CAP at most
MANO_NEW_GRAD_CAP = 5e-2


def encoder_conv_dtypes(model, run) -> set:
    """The output dtypes of every encoder conv in one call of `run`."""
    seen = set()
    hooks = [m.register_forward_hook(lambda m, i, o: seen.add(o.dtype))
             for m in model.encoder.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


def phase_mano_new(batch: dict, profile: bool) -> dict:
    """Phase 19: the mano_new eval step at the config's val_batch (16) and
    its train step at its train_batch (64), 224^2, on the flagship batch
    with the config's keys. Returns the launches of both (none: no TPU
    kernel runs on this path)."""
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_eval_step, make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    t0 = time.perf_counter()
    cfg = Config.from_json(MANO_NEW_CONFIG)
    check((cfg.hand_model, cfg.render, cfg.image_size, cfg.val_batch, cfg.train_batch) == ("mano_new", False, S, 16, B),
          f"the shipped mano_new config: {cfg.hand_model}, render {cfg.render}, {cfg.val_batch}, {cfg.train_batch}")
    eval_batch = {k: batch[k][:cfg.val_batch] for k in MANO_NEW_KEYS}
    train_batch = {k: batch[k][:cfg.train_batch] for k in MANO_NEW_KEYS}
    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, "FreiHand", cfg)
    step(eval_batch)
    torch.cuda.synchronize()
    reset_launches()
    out = step(eval_batch)
    torch.cuda.synchronize()
    launches = {"mano_new_eval_step": read_launches()}
    check(not any(launches["mano_new_eval_step"].values()), f"no TPU kernel on the mano_new eval path: {launches}")
    n = cfg.val_batch
    shapes = {"joints": (n, 21, 3), "mano_verts": (n, 778, 3), "j2d": (n, 21, 2), "pose_params": (n, 48),
              "shape_params": (n, 10)}
    check({k: tuple(v.shape) for k, v in out.items()} == shapes, f"mano_new eval outputs {list(out)}")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()), "mano_new eval outputs finite")
    dtypes = encoder_conv_dtypes(model, lambda: step(eval_batch))
    check(dtypes == {torch.float32}, f"the mano_new encoder runs in fp32 under compute_dtype "
                                     f"{cfg.compute_dtype}: {dtypes}")
    print(f"mano_new eval step: outputs finite, no TPU kernel on this path ({launches['mano_new_eval_step']}), "
          f"encoder convs in {sorted(map(str, dtypes))}")

    # fp32 on the card against the CPU at the slice test's size
    small_cfg = Config.from_json(MANO_NEW_CONFIG, image_size=32)
    small = {k: v for k, v in slice_batch().items() if k in MANO_NEW_KEYS}
    gpu32 = make_eval_step(build_model(small_cfg, device="cuda", seed=0), "FreiHand", small_cfg)(
        {k: v.cuda() for k, v in small.items()})
    cpu32 = make_eval_step(build_model(small_cfg, device="cpu", seed=0), "FreiHand", small_cfg)(small)
    diffs = {k: (gpu32[k].cpu() - cpu32[k]).abs().max().item() for k in shapes}
    print(f"fp32 mano_new eval step, card vs CPU (res50, 32 px, 8 images): max abs {diffs}")
    check(diffs["joints"] < 1e-5 and diffs["mano_verts"] < 1e-5 and diffs["j2d"] < 1e-3,
          "joints and verts within 1e-5 m, j2d within 1e-3 px")
    torch.cuda.reset_peak_memory_stats()
    numbers = time_steps(lambda: step(eval_batch), n)
    numbers["device_busy_ms"], numbers["launches_per_step"] = device_profile(lambda: step(eval_batch))
    print("mano_new eval step: " + json.dumps(numbers))

    state = create_train_state(model, cfg)
    tstep = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    sched = make_sched(cfg, 0)
    for _ in range(2):
        state, d = tstep(state, train_batch, sched)
    torch.cuda.synchronize()
    before = state.optimizer.flat.clone()
    reset_launches()
    state, d = tstep(state, train_batch, sched)
    torch.cuda.synchronize()
    launches["mano_new_train_step"] = read_launches()
    check(not any(launches["mano_new_train_step"].values()), f"no TPU kernel on the mano_new train path: {launches}")
    losses = {k: v.item() for k, v in d.items()}
    print("mano_new train step losses: " + json.dumps(losses))
    check(set(losses) == set(cfg.losses) | {"total", "skipped"}, f"the 2 terms, total and skipped: {sorted(losses)}")
    check(all(np.isfinite(v) for v in losses.values()) and losses["skipped"] == 0.0, "terms finite, not skipped")
    changed = (state.optimizer.flat != before).float().mean().item()
    check(changed > 0.5, f"the parameters changed ({changed})")
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, d = tstep(state, train_batch, sched)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("mano_new train step: one step ran under set_sync_debug_mode('error'), no host sync")

    gl, gg, _ = one_train_step(small_cfg, small, "cuda")
    cl, cg, _ = one_train_step(small_cfg, small, "cpu")
    _, ug, _ = one_train_step(small_cfg, dict(small, imgs=torch.nextafter(small["imgs"], torch.tensor(2.0))), "cpu")
    term_err = {k: abs(gl[k] - cl[k]) / max(abs(cl[k]), 1e-30) for k in cl if k != "skipped"}
    worst, heads = [], {}
    for name, ref in cg.items():
        nr = ref.norm().item()
        if nr == 0:  # the shape head: use_mean_shape zeroes beta
            check(gg[name].norm().item() == 0, f"{name}'s gradient zero on the card too")
            continue
        err = (gg[name] - ref).norm().item() / nr
        if name in MANO_NEW_HEADS:
            heads[name] = err
            continue
        tol = min(MANO_NEW_GRAD_CAP, max(1e-3, 20 * (ug[name] - ref).norm().item() / nr))
        worst.append((err / tol, name, err, tol))
    worst.sort(reverse=True)
    print(f"fp32 mano_new train step (res50, 32 px, 8 images), card vs CPU: loss term rel err {term_err}, heads' "
          f"gradients rel L2 {heads}, encoder worst (err / tol, name, err, tol) {worst[:3]}")
    check(max(term_err.values()) <= 1e-4, "loss terms within 1e-4 of the CPU plain path")
    check(max(heads.values()) <= 1e-3, "the heads' gradients within 1e-3 relative L2 of the CPU's")
    check(worst[0][0] < 1.0, "the encoder's gradients within 20x the CPU's own one-ulp movement")

    torch.cuda.reset_peak_memory_stats()
    numbers = time_steps(lambda: tstep(state, train_batch, sched), cfg.train_batch)
    numbers["device_busy_ms"], numbers["launches_per_step"] = device_profile(lambda: tstep(state, train_batch, sched))
    numbers["tf32"] = {"cudnn": torch.backends.cudnn.allow_tf32, "matmul": torch.backends.cuda.matmul.allow_tf32}
    print("mano_new train step: " + json.dumps(numbers))
    if profile:
        profile_steps(lambda b: tstep(state, b, sched), train_batch)
    print(f"phase mano_new: {time.perf_counter() - t0:.1f} s")
    return launches


def phase_mano_new_entry(tmp: str, tree: str) -> dict:
    """Phase 20: `python -m hifihr_tpu_torch.train` in-process on the
    shipped mano_new config, reading the tree of phase 18; only the paths,
    controlled_size (with controlled_exp) MANO_NEW_TRAIN (10 steps of 64),
    total_epochs 1 and save_interval 1 moved; an eval of the tree's 3,960
    evaluation frames after the epoch. Returns the launches per Trainer
    step."""
    from hifihr_tpu_torch import train as entry

    t0 = time.perf_counter()
    with open(MANO_NEW_CONFIG) as f:
        raw = json.load(f)
    out = os.path.join(tmp, "mano_new_out")
    raw.update(freihand_base_path=tree, base_out_path=out, controlled_exp=True, controlled_size=MANO_NEW_TRAIN,
               total_epochs=1, save_interval=1)
    path = os.path.join(tmp, "mano_new_tree.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    subs = _Substitutions()
    logging.getLogger().addHandler(subs)
    try:
        with trainer_probes({}) as run:
            entry.main(["--config_json", path])
    finally:
        logging.getLogger().removeHandler(subs)
    check(not subs.messages, f"no sample substituted: {subs.messages[:3]}")
    log = _read_log(out)
    epochs = [r for r in log if "train_loss" in r]
    check([r["epoch"] for r in epochs] == [0] and epochs[0]["skipped_steps"] == 0, f"one epoch, none skipped: {epochs}")
    steps = [r for r in log if "step" in r]
    check(steps and all(np.isfinite(v) for r in steps for k, v in r.items() if isinstance(v, float)),
          "every logged term finite")
    # the tree has no evaluation_verts.json, so no PA-MPJPE (phase 18), and
    # mano_new renders nothing: the record says the eval ran to its end
    evals = [r["eval"] for r in log if "eval" in r]
    check(len(evals) == 1 and all(np.isfinite(v) for v in evals[0].values() if isinstance(v, float)),
          f"the eval finished, finite: {evals}")
    check([r["batches"] for r in run["evals"].values()] == [-(-FREI_EVAL // 16)],
          f"the eval ran over the tree's {FREI_EVAL} frames: {run['evals']}")
    trainer = run["trainer"]
    check(len(trainer.val_loader.dataset) == FREI_EVAL and len(trainer.train_loader) == MANO_NEW_TRAIN // 64,
          "the eval covers FreiHAND's 3,960 frames and the epoch is 10 steps of 64")
    per_step = {}
    for key, runs in (("trainer_mano_new_train_step", run["epochs"]), ("trainer_mano_new_eval_step", run["evals"])):
        counts = [r["launches"] for r in runs.values()]
        check(not any(v for c in counts for v in c.values()), f"no TPU kernel in the {key}: {counts}")
        per_step[key] = counts[0]
    numbers = {"images_per_sec": epochs[0]["images_per_sec"], "train_loss": epochs[0]["train_loss"],
               "epoch_seconds": run["epochs"][0]["seconds"],
               "prefetch_wait_share": run["epochs"][0]["prefetch_wait_s"] / run["epochs"][0]["seconds"],
               "eval_seconds": [r["seconds"] for r in run["evals"].values()], "eval": evals[0]}
    print("trainer (mano_new, FreiHAND tree): " + json.dumps(numbers))
    print(f"phase mano_new entry: {time.perf_counter() - t0:.1f} s")
    return per_step


def texture_quad(cfg, batch: dict, what: str) -> dict:
    """K2 and K3 on the texture quad fetch of `cfg`'s UV render (the
    per-pixel fetch of render/texture.py::sample_texture), on the real
    inputs of one train step of a fresh model: K2 bit-equal and K3 within
    its bound, their times, the plain versions', the bounds, the library's
    indexing and index_add_, and torch's grid_sample (bilinear, border,
    align_corners=True on 2 uv - 1) as the library call for the whole
    sample, with its difference from sample_texture."""
    import torch.nn.functional as Fn

    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.render import renderer as rmod
    from hifihr_tpu_torch.render.texture import sample_texture
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    model = build_model(cfg, device="cuda", seed=0)
    state = create_train_state(model, cfg)
    step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    sampled = []
    orig = rmod.sample_texture

    def record(tex, uv):
        sampled.append((tex.detach().clone(), uv.detach().clone()))
        return orig(tex, uv)

    rmod.sample_texture = record
    try:
        with captured_kernel_inputs() as got:
            step(state, batch, make_sched(cfg, 0))
    finally:
        rmod.sample_texture = orig
    tex, uv = sampled[0]
    n, ht, wt, c = tex.shape
    k2_in = [(t, i) for t, i in got["K2"] if t.shape[1] == ht * wt and t.shape[2] == 4 * c]
    k3_in = [(g, i, r) for g, i, r in got["K3"] if r == ht * wt and g.shape[2] == 4 * c]
    check(len(k2_in) >= 1 and len(k3_in) == 1, f"the quad's K2 and K3 launches in {what}'s train step: "
                                               f"{len(k2_in)}, {len(k3_in)}")
    table, idx = k2_in[0]
    out = {"K2": k2_reading(table, idx, f"the texture quad of {what}")}
    g, gidx, rows = k3_in[0]
    out["K3"] = k3_launch(g, gidx, rows, f"the texture quad's backward in {what}")
    out["K3"]["plain_ms"], out["K3"]["library_ms"] = k3_yardsticks(g, gidx, rows)

    def grid():
        return Fn.grid_sample(tex.permute(0, 3, 1, 2), 2.0 * uv - 1.0, mode="bilinear", padding_mode="border",
                              align_corners=True).permute(0, 2, 3, 1)

    ours = sample_texture(tex, uv)
    diff = (grid() - ours).abs().max().item()
    check(diff <= 1e-5, f"grid_sample computes sample_texture's function within 1e-5 on {what}: {diff}")
    out["sample"] = {"texture": list(tex.shape), "uv": list(uv.shape), "grid_sample_max_abs_diff": diff,
                     "sample_texture_ms": time_ms(lambda: sample_texture(tex, uv), reps=20),
                     "grid_sample_ms": time_ms(grid, reps=20)}
    print(f"texture quad on {what}: " + json.dumps(out["sample"]))
    return out


# phase 23: test-time MANO fitting in the Trainer's eval
FIT_JOINTS_TOL = 1e-4  # m: the refined joints, card against CPU (tests/test_torch_fitting.py)
FIT_EVAL_SAMPLES = 128  # 8 eval batches of 16, for the script's time limit


def phase_fitting() -> dict:
    """Phase 23: configs/smoke_render.json with test_refinement through the
    entry's evaluation (`--mode evaluation`) on the synthetic stand-in,
    then one batch's fit on the card against the CPU, its time, its
    launches per step and its host syncs."""
    import tempfile

    from hifihr_tpu_torch import train as entry
    from hifihr_tpu_torch.hand.mano import ManoLayer, regress_joints_frei
    from hifihr_tpu_torch.training import fitting, loop

    t0 = time.perf_counter()
    first = []
    orig = loop.Trainer._refine

    def refine(self, out, batch):
        if not first:
            first.append({k: out[k].clone() for k in ("pose_params", "shape_params", "trans", "scale", "j2d")}
                         | {k: batch[k].clone() for k in ("Ks", "root_xyz", "j2d_gt") if k in batch})
        return orig(self, out, batch)

    loop.Trainer._refine = refine
    try:
        with tempfile.TemporaryDirectory(prefix="hifihr_fit_") as tmp, trainer_probes({}) as run:
            result = entry.main(["--config_json", _smoke_render_copy(tmp, "fit", test_refinement=True,
                                                                     controlled_size=FIT_EVAL_SAMPLES),
                                 "--mode", "evaluation"])
    finally:
        loop.Trainer._refine = orig
    check(all(np.isfinite(result.get(k, np.nan)) for k in ("pa_mpjpe_cm", "pa_mpjpe_refined_cm")),
          f"pa_mpjpe_cm and pa_mpjpe_refined_cm finite: {result}")
    ev = run["evals"][-1]
    print(f"fitting eval: pa_mpjpe_cm {result['pa_mpjpe_cm']}, pa_mpjpe_refined_cm {result['pa_mpjpe_refined_cm']}, "
          f"{ev['batches']} batches in {ev['seconds']:.2f} s, launches {ev['launches']}")

    x = first[0]
    target = x.get("j2d_gt", x["j2d"])
    args = (x["pose_params"], x["shape_params"], x["trans"], x["scale"], x["Ks"][:, :3, :3], target,
            torch.ones_like(target[..., :1]), x["root_xyz"])
    mano, cpu_mano = ManoLayer(ncomps=45), ManoLayer(ncomps=45)
    fit_gpu = fitting.make_fitting_fn(mano, device="cuda")
    fit_cpu = fitting.make_fitting_fn(cpu_mano, device="cpu")
    pg = fit_gpu(*args)
    pc = fit_cpu(*(a.cpu() for a in args))
    diffs = {k: (pg[k].cpu() - pc[k]).abs().max().item() for k in fitting.PARAMS}

    def joints(p, layer):
        with torch.no_grad():
            v = layer(p["pose"], p["betas"]).verts
            j = regress_joints_frei(v, layer.J_regressor)
            return j - j[:, 9:10]

    jdiff = (joints(pg, mano).cpu() - joints(pc, cpu_mano)).abs().max().item()
    moved = max((pg[k] - a).abs().max().item() for k, a in zip(fitting.PARAMS, args))
    print(f"fit of one batch ({tuple(x['pose_params'].shape)}), card vs CPU: params max abs {diffs}, refined joints "
          f"max abs {jdiff} m; the fit moved the parameters by up to {moved}")
    check(jdiff <= FIT_JOINTS_TOL, f"the refined joints within {FIT_JOINTS_TOL} m of the CPU's")
    ms = time_ms(lambda: fit_gpu(*args), reps=1, groups=3)
    busy, launches = device_profile(lambda: fit_gpu(*args), reps=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fit_gpu(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)]
    numbers = {"batch": x["pose_params"].shape[0], "steps": fitting.N_STEPS, "ms_per_fit": ms,
               "device_busy_ms_per_fit": busy, "launches_per_fit_step": launches / fitting.N_STEPS,
               "host_syncs_per_fit": len(syncs), "syncs": syncs[:5],
               "eval_seconds": ev["seconds"], "eval_batches": ev["batches"],
               "pa_mpjpe_cm": result["pa_mpjpe_cm"], "pa_mpjpe_refined_cm": result["pa_mpjpe_refined_cm"]}
    print("test-time fitting: " + json.dumps(numbers))
    check(not syncs, f"no host sync inside the fit: {syncs[:5]}")
    print(f"phase fitting: {time.perf_counter() - t0:.1f} s")
    return numbers



# phases 24-28: multi-rank training (two ranks sharing the one card under
# gloo; over two cards under NCCL where there are two) and the rgb2hm branch
HM_LOSSES = ("kp_cons", "hm_integral", "hm_integral_gt", "open_2dj_de", "joint_3d_norm")
DIST_TIMEOUT_S = 300  # of a whole multi-rank run; every collective times out after 120 s
INVARIANCE_RTOL = 1e-4  # 1 rank against 2 (tests/test_torch_parallel.py)
# the hourglass's gradients at 32 px, batch 8, card against CPU: JAX's own
# move under one ulp of input is up to 6.5e-2 there (tests/test_torch_rgb2hm.py)
HOURGLASS_GRAD_TOL = 5e-2


def with_openpose(batch: dict, seed: int = 5) -> dict:
    """`batch` with seeded openpose pseudo-labels and confidences
    (`open_2dj`, `open_2dj_con`), so that every heatmap term fires."""
    n, size = batch["imgs"].shape[:2]
    rng = np.random.RandomState(seed)
    dev = batch["imgs"].device
    return dict(batch, open_2dj=torch.tensor(rng.rand(n, 21, 2) * size, dtype=torch.float32, device=dev),
                open_2dj_con=torch.tensor(rng.uniform(0.0, 1.0, (n, 21, 1)), dtype=torch.float32, device=dev))


def varied_slice_batch(n: int = 8, size: int = 32, seed: int = 0) -> dict:
    """The slice tests' batch with rows that differ in every key and
    openpose pseudo-labels (tests/torch_port_helpers.py::varied_batch), on
    the host, so that no per-rank reduction that is wrong can cancel out."""
    rng = np.random.RandomState(seed)
    root = np.stack([rng.uniform(-0.02, 0.02, n), rng.uniform(-0.02, 0.02, n),
                     rng.uniform(0.45, 0.6, n)], -1)[:, None].astype(np.float32)
    f = size * 1.8
    K = np.tile(np.asarray([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)[None], (n, 1, 1))
    K[:, :2, :2] *= rng.uniform(0.9, 1.1, (n, 1, 1)).astype(np.float32)
    b = {
        "imgs": rng.rand(n, size, size, 3).astype(np.float32), "Ks": K, "root_xyz": root,
        "joints": (rng.randn(n, 21, 3) * 0.03 + root).astype(np.float32),
        "j2d_gt": (rng.rand(n, 21, 2) * size).astype(np.float32),
        "verts": (rng.randn(n, 778, 3) * 0.03 + root).astype(np.float32),
        "segms_gt": (rng.rand(n, size, size) > rng.uniform(0.3, 0.8, (n, 1, 1))).astype(np.float32),
        "texture_con": rng.uniform(0.2, 1.0, n).astype(np.float32),
        "open_2dj": (rng.rand(n, 21, 2) * size).astype(np.float32),
        "open_2dj_con": rng.uniform(0.0, 1.0, (n, 21, 1)).astype(np.float32),
        "scales": rng.uniform(0.025, 0.032, n).astype(np.float32),
    }
    return {k: torch.tensor(v) for k, v in b.items()}


def _rank_state(cfg, device, mesh):
    """A freshly built model (seed 0) on `mesh`, its train state and step."""
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.parallel.mesh import replicate
    from hifihr_tpu_torch.training.steps import make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    model = build_model(cfg, device=device, seed=0)
    if mesh is not None:
        replicate(model, mesh)
    state = create_train_state(model, cfg, mesh=mesh)
    return model, state, make_train_step(model, LossComputer(cfg, mesh), "FreiHand", cfg)


def dp_flagship_rank(rank: int, world: int, device, fsdp: int) -> dict:
    """Phase 24 on one rank (a parallel.launch.spawn_ranks target): the
    flagship train step on this rank's rows of the flagship batch (global
    64) over the current process group; K1, K2 and K3 held against their
    plain versions on this rank's inputs at step 1; its launches, median,
    device busy time and peak memory; and, after the timed steps, whether
    its flat parameters equal rank 0's bit for bit."""
    import torch.distributed as dist

    from hifihr_tpu_torch.parallel.mesh import make_mesh
    from hifihr_tpu_torch.training.steps import make_sched

    cfg = step_config()
    mesh = make_mesh(fsdp, device)
    _, state, step = _rank_state(cfg, device, mesh)
    sched = make_sched(cfg, 0, device)
    batch = mesh.shard_batch(flagship_batch(device))
    what = f"rank {rank} of {world}"
    with captured_kernel_inputs() as first:
        state, d = step(state, batch, sched)
    first_totals = [d["total"].item(), step(state, batch, sched)[1]["total"].item()]  # and allocator warm-up
    held = {"K1": [k1_route(coef, bbox, f"the dp train step's hand, {what}", size, samples=samples)["route_ms"]
                   for coef, bbox, size, samples in first["K1"]],
            "K2": check_k2_captures(first["K2"], f"the dp train step, {what}"),
            "K3": [k3_launch(g, idx, n, f"the dp train step, {what}")["ms"] for g, idx, n in first["K3"]]}
    first.clear()
    reset_launches()
    state, d = step(state, batch, sched)
    torch.cuda.synchronize()
    launches = read_launches()
    check_route_launches(launches, f"the dp train step, {what}")
    check(launches == {"K1 msaa_raster": 1, "K2 gather_rows": 1, "K3 scatter_rows": 1, "K4 face_raster": 0},
          f"K1, K2 and K3 once each in the dp train step, {what}: {launches}")
    losses = {k: v.item() for k, v in d.items()}
    check(set(losses) == set(FIRED) | {"skipped"} and all(np.isfinite(list(losses.values())))
          and losses["skipped"] == 0.0, f"15 finite terms, not skipped, {what}: {losses}")
    torch.cuda.reset_peak_memory_stats()
    numbers = time_steps(lambda: step(state, batch, sched), B)  # images/s of the global batch
    numbers["device_busy_ms"], numbers["launches_per_step"] = device_profile(lambda: step(state, batch, sched))
    taken = 3 + 2 * STEPS + 3
    check(int(state.step) == taken, f"every step of {what} updated (none skipped): {int(state.step)} of {taken}")
    opt = state.optimizer
    ref = opt.flat.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    numbers.update(rank=rank, world=world, fsdp=fsdp, backend=dist.get_backend(), launches=launches,
                   losses=losses, held_ms=held, flat_equal_rank0=bool(torch.equal(ref, opt.flat)),
                   total_final=d["total"].item(), totals_steps_1_2=first_totals)
    print(f"dp train step, {what}: " + json.dumps(numbers))
    return numbers


def phase_dp_flagship() -> dict:
    """Phase 24: the flagship train step at full width over two ranks that
    share the one card under gloo (32 rows each), and over two cards under
    NCCL (fsdp 1 and 2) where there are two."""
    from hifihr_tpu_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    out = {}
    runs = [("gloo_one_card", "gloo", "cuda:0", 1)]
    if torch.cuda.device_count() >= 2:
        runs += [("nccl_two_cards", "nccl", None, 1), ("nccl_two_cards_fsdp2", "nccl", None, 2)]
    else:
        print(f"dp train step over two cards under NCCL (fsdp 1 and 2): not run, {torch.cuda.device_count()} card")
    for key, backend, device, fsdp in runs:
        ranks = spawn_ranks(dp_flagship_rank, 2, (fsdp,), backend=backend, device=device,
                            timeout_s=DIST_TIMEOUT_S)
        check(all(r["flat_equal_rank0"] for r in ranks), f"{key}: the ranks' flat parameters equal bit for bit")
        check(all(r["total_final"] == ranks[0]["total_final"] for r in ranks), f"{key}: one global total")
        out[key] = {"totals_steps_1_2": ranks[0]["totals_steps_1_2"],
                    "median_ms": max(r["median_ms"] for r in ranks),
                    "images_per_s_global": B / max(r["median_ms"] for r in ranks) * 1e3,
                    "device_busy_ms_per_rank": [r["device_busy_ms"] for r in ranks],
                    "launches_per_step_per_rank": [r["launches_per_step"] for r in ranks],
                    "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in ranks],
                    "kernel_launches_per_rank": [r["launches"] for r in ranks],
                    "back_to_back_ms": max(r["back_to_back_ms"] for r in ranks)}
        print(f"dp train (64) {key}: " + json.dumps(out[key]))
        # every layout trains the same: the first step's global total within
        # 1e-6 of the one-card run's, the second's within 1e-3 (it follows
        # the first update, where Adam turns rounding-level gradients into
        # +-lr moves: 1.2e-4 measured between gloo on one H100 and NCCL on two)
        ref = out["gloo_one_card"]["totals_steps_1_2"]
        got = out[key]["totals_steps_1_2"]
        check(abs(got[0] - ref[0]) <= 1e-6 * abs(ref[0]) and abs(got[1] - ref[1]) <= 1e-3 * abs(ref[1]),
              f"{key}'s totals at steps 1-2 within 1e-6 and 1e-3 of the one-card run's: {got} vs {ref}")
    print(f"phase dp train: {time.perf_counter() - t0:.1f} s")
    return out


def nccl_world1_rank(rank: int, world: int, device) -> dict:
    """Phase 25 in its one process (a spawn_ranks target under NCCL): the
    flagship train step without a process group, and the same step on the
    one-rank NCCL mesh with every collective counted, under PyTorch's
    deterministic algorithms (the renderer's index_add_ of vertex normals
    otherwise sums with atomics, so two runs' terms can differ in their last
    bits; a second run without a group shows that they do not). K3 sums with
    fp32 atomics whatever that mode says, so two runs' gradients differ in
    their last bits: the distributed step's gradient all-reduce is fed the
    first run's gradient, and must return it bit for bit, and the update,
    the loss terms and the BatchNorm statistics must then equal the first
    run's bit for bit."""
    import torch.distributed as dist

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)

    from hifihr_tpu_torch.parallel.mesh import make_mesh
    from hifihr_tpu_torch.training.steps import make_sched

    cfg = step_config()
    batch = flagship_batch(device)
    sched = make_sched(cfg, 0, device)
    model_a, state_a, step_a = _rank_state(cfg, device, None)
    _, d_a = step_a(state_a, batch, sched)
    grad_a = state_a.optimizer.grad.clone()
    _, state_c, step_c = _rank_state(cfg, device, None)  # a second run: K3's run-to-run spread
    _, d_c = step_c(state_c, batch, sched)
    control = all(torch.equal(d_a[k], d_c[k]) for k in d_a)
    spread = ((state_c.optimizer.grad - grad_a).norm() / grad_a.norm()).item()
    del state_c, step_c
    mesh = make_mesh(1, device)
    model_b, state_b, step_b = _rank_state(cfg, device, mesh)
    opt, reduce = state_b.optimizer, state_b.optimizer._reduced_grad
    own = {}

    def replay():
        own["grad"] = opt.grad.clone()
        opt.grad.copy_(grad_a)
        g = reduce()
        own["returned_equal"] = bool(torch.equal(g, grad_a))
        return g

    calls = []
    all_reduce = dist.all_reduce

    def counted(t, *a, **kw):
        calls.append(t.numel())
        return all_reduce(t, *a, **kw)

    opt._reduced_grad, dist.all_reduce = replay, counted
    try:
        _, d_b = step_b(state_b, batch, sched)
    finally:
        opt._reduced_grad, dist.all_reduce = reduce, all_reduce
    torch.cuda.synchronize()
    stats = [k for k in model_a.state_dict() if k.endswith(("running_mean", "running_var"))]
    sd_a, sd_b = model_a.state_dict(), model_b.state_dict()
    rel = ((own["grad"] - grad_a).norm() / grad_a.norm()).item()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(), "collectives": len(calls),
           "gradient_all_reduce_ran": opt.n in calls, "all_reduce_returned_its_input": own["returned_equal"],
           "terms_bit_equal": all(torch.equal(d_a[k], d_b[k]) for k in d_a) and set(d_a) == set(d_b),
           "update_bit_equal": bool(torch.equal(state_a.optimizer.flat, opt.flat)),
           "batchnorm_stats_bit_equal": all(torch.equal(sd_a[k], sd_b[k]) for k in stats),
           "own_gradient_rel_l2_to_first_run": rel, "second_run_without_group_rel_l2": spread,
           "second_run_without_group_terms_bit_equal": control}
    print("NCCL world 1: " + json.dumps(out))
    return out


def phase_nccl_world1() -> dict:
    """Phase 25: the flagship train step in a process group of one rank
    under NCCL against the step without one (nccl_world1_rank)."""
    from hifihr_tpu_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    out = spawn_ranks(nccl_world1_rank, 1, backend="nccl", device="cuda:0", timeout_s=DIST_TIMEOUT_S)[0]
    check(out["backend"] == "nccl" and out["world"] == 1, f"a process group of one rank under NCCL: {out}")
    check(out["second_run_without_group_terms_bit_equal"], f"two runs without a group agree bit for bit: {out}")
    check(out["gradient_all_reduce_ran"] and out["collectives"] >= 4,
          f"the gradient all-reduce and the loss collectives ran: {out}")
    check(out["all_reduce_returned_its_input"] and out["terms_bit_equal"] and out["update_bit_equal"]
          and out["batchnorm_stats_bit_equal"], f"the NCCL world-1 step bit-equal to the step without it: {out}")
    print(f"phase NCCL world 1: {time.perf_counter() - t0:.1f} s")
    return out


def small_rank(rank: int, world: int, device, cfg, batch: dict, steps: int = 2) -> dict:
    """Phase 26 on one rank (a spawn_ranks target, or in-process without a
    process group): `steps` train steps of `cfg` on this rank's rows of the
    host `batch`; every step's terms and the flat parameters."""
    from hifihr_tpu_torch.parallel.mesh import make_mesh
    from hifihr_tpu_torch.training.steps import make_sched

    mesh = make_mesh(1, device)
    _, state, step = _rank_state(cfg, device, mesh)
    sched = make_sched(cfg, 0, device)
    rows = mesh.shard_batch({k: v.to(device) for k, v in batch.items()})
    losses = []
    for _ in range(steps):
        state, d = step(state, rows, sched)
        losses.append({k: v.item() for k, v in d.items()})
    return {"losses": losses, "flat": state.optimizer.flat.cpu(), "step": int(state.step)}


def phase_invariance() -> dict:
    """Phase 26: 1 rank against 2 ranks sharing the card under gloo, in fp32
    (TF32 off) at res18, 32 px, a global batch of 8 varied rows, with the
    flagship losses, open_2dj, both photometric triples and the rgb2hm
    branch with hm_integral (every ratio term fires): every term at step 1
    and the total at step 2 within 1e-4 relative, step 2's terms within
    1e-2 (the first update is chaotic: tests/test_torch_parallel.py), the
    parameters bit-equal across the ranks."""
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    cfg = Config(**dict(SLICE_CFG, losses=LOSSES + ("open_2dj", "hm_integral"), rgb2hm=True))
    batch = varied_slice_batch()
    one = small_rank(0, 1, "cuda:0", cfg, batch)
    two = spawn_ranks(small_rank, 2, (cfg, batch), backend="gloo", device="cuda:0", timeout_s=DIST_TIMEOUT_S)
    check(torch.equal(two[0]["flat"], two[1]["flat"]), "the two ranks' parameters equal bit for bit")
    err = {}
    for step_i in range(2):
        for k, v in one["losses"][step_i].items():
            if k == "skipped":
                check(v == 0.0 and all(r["losses"][step_i][k] == 0.0 for r in two), "no step skipped")
                continue
            check(v != 0.0, f"{k} fires")
            err[f"step{step_i + 1}_{k}"] = max(abs(r["losses"][step_i][k] - v) / abs(v) for r in two)
    worst1 = max(v for k, v in err.items() if k.startswith("step1"))
    out = {"worst_step1_term": worst1, "step2_total": err["step2_total"],
           "worst_step2_term": max(v for k, v in err.items() if k.startswith("step2")), "errors": err}
    print("invariance, 1 rank against 2 (res18, fp32, 32 px, 8 varied rows): " + json.dumps(out))
    check(worst1 <= INVARIANCE_RTOL and err["step2_total"] <= INVARIANCE_RTOL,
          f"every step-1 term and the step-2 total within {INVARIANCE_RTOL}")
    check(out["worst_step2_term"] <= 1e-2, "step 2's terms within 1e-2")
    print(f"phase invariance: {time.perf_counter() - t0:.1f} s")
    return out


def hourglass_share(model, batch: dict, busy_ms: float, train: bool, what: str) -> dict:
    """The rgb2hm hourglass alone on the step's images (forward, and the
    backward of its heatmaps' mean when `train`): device ms (torch.profiler)
    and its share of the step's device busy time."""
    imgs = batch["imgs"]

    def run():
        with torch.set_grad_enabled(train):
            hms = model.rgb2hm(imgs)
        if train:
            sum(h.mean() for h in hms).backward()

    model.rgb2hm.train(train)
    dev = device_profile(run)[0]
    out = {"device_ms": dev, "events_ms": time_ms(run, reps=3), "share_of_step": dev / busy_ms}
    print(f"rgb2hm hourglass on {what}'s {imgs.shape[0]} images ({'forward + backward' if train else 'forward'}): "
          + json.dumps(out))
    return out


def entry_rank(rank: int, world: int, device, argv: list) -> dict:
    """Phase 28 on one rank (a spawn_ranks target): the entry's main with
    `argv` in the process group the launcher started, the Trainer's epochs
    and evals probed (trainer_probes) on this rank."""
    from hifihr_tpu_torch import train as entry

    with trainer_probes({}) as run:
        entry.main(argv)
    return {"epochs": {str(e): {k: v for k, v in r.items()} for e, r in run.get("epochs", {}).items()},
            "evals": {str(e): {k: v for k, v in r.items()} for e, r in run.get("evals", {}).items()}}


def phase_trainer_two_ranks() -> dict:
    """Phase 28: configs/smoke_render.json as it ships (global batch 16,
    the encoder in bf16; 256 samples a split here) through the entry at 2
    ranks sharing the card under gloo: 1 epoch and its eval, rank 0 alone
    writing; the same checkpoint evaluated at 1 rank (metrics within 1e-5,
    and whether they are equal to the bit), and at 2 ranks through
    torchrun, the entry's launcher (`python -m torch.distributed.run
    --standalone --nproc_per_node=2 -m hifihr_tpu_torch.train ...
    --dist_backend gloo`); then a 1-rank resume of the 2-rank checkpoint
    for a second epoch. Each rank evaluates whole batches of 16
    (training/loop.py), the shapes of the 1-rank eval: split by row, cuDNN
    rounded a row differently in a call of 8 rows than in one of 16, and
    LPIPS (whose feature normalisation magnifies last-bit differences)
    moved by 5.3e-6 and 1.2e-5 relative in two runs on an H100, with the
    encoder in fp32."""
    import tempfile

    from hifihr_tpu_torch import train as entry
    from hifihr_tpu_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    over = dict(total_epochs=1, controlled_size=256)
    out = {}
    with tempfile.TemporaryDirectory(prefix="hifihr_dp_trainer_") as tmp:
        two = _smoke_render_copy(tmp, "two", **over)
        t1 = time.perf_counter()
        ranks = spawn_ranks(entry_rank, 2, (["--config_json", two, "--dist_backend", "gloo"],), backend="gloo",
                            device="cuda:0", timeout_s=DIST_TIMEOUT_S)
        out["two_rank_seconds"] = time.perf_counter() - t1
        for r, run in enumerate(ranks):
            for e, rec in run["epochs"].items():
                check(all(rec["launches"][k] == rec["steps"] for k in ("K1 msaa_raster", "K2 gather_rows",
                                                                      "K3 scatter_rows")),
                      f"rank {r}'s epoch {e} launched K1, K2 and K3 once a step: {rec}")
            out[f"rank{r}"] = run
        log = _read_log(os.path.join(tmp, "two"))
        epochs = [x for x in log if "train_loss" in x]
        evals = [x["eval"] for x in log if "eval" in x]
        steps = [x["step"] for x in log if "step" in x and "loss" in x]
        check(len(epochs) == 1 and len(evals) == 1 and len(steps) == len(set(steps)),
              f"rank 0 alone wrote train_log.jsonl: {len(epochs)} epoch and {len(evals)} eval records")
        check(epochs[0]["skipped_steps"] == 0 and np.isfinite(epochs[0]["train_loss"]), f"{epochs[0]}")
        with open(os.path.join(tmp, "two", "train.log")) as f:
            check(f.read().count("best PA-MPJPE") == 1, "rank 0 alone wrote train.log")
        model_dir = os.path.join(tmp, "two", "model")
        one = _smoke_render_copy(tmp, "one", pretrain_model=model_dir, **over)
        t1 = time.perf_counter()
        single = entry.main(["--config_json", one, "--mode", "evaluation"])
        out["one_rank_eval_seconds"] = time.perf_counter() - t1
        metrics = sorted(k for k, v in single.items() if isinstance(v, float))
        diff = {k: abs(evals[0][k] - single[k]) / max(abs(single[k]), 1e-12) for k in metrics}
        out["eval_two_ranks"], out["eval_one_rank"], out["eval_rel_diff"] = evals[0], single, diff
        out["eval_bit_equal"] = all(evals[0][k] == single[k] for k in metrics)
        check({"pa_mpjpe_cm", "tex_psnr"} <= set(metrics) and max(diff.values()) <= 1e-5,
              f"the 2-rank eval equals the 1-rank eval of its checkpoint within 1e-5: {diff}")
        viarun = _smoke_render_copy(tmp, "torchrun", pretrain_model=model_dir, **over)
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
                               "-m", "hifihr_tpu_torch.train", "--config_json", viarun, "--mode", "evaluation",
                               "--dist_backend", "gloo"], cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=DIST_TIMEOUT_S)
        out["torchrun_eval_seconds"] = time.perf_counter() - t1
        check(proc.returncode == 0, f"torchrun's 2-rank evaluation: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        tr = [x["eval"] for x in _read_log(os.path.join(tmp, "torchrun")) if "eval" in x]
        tdiff = {k: abs(tr[0][k] - single[k]) / max(abs(single[k]), 1e-12) for k in metrics}
        check(len(tr) == 1 and max(tdiff.values()) <= 1e-5, f"torchrun's 2-rank eval equals the 1-rank eval: {tdiff}")
        out["torchrun_eval_bit_equal"] = all(tr[0][k] == single[k] for k in metrics)
        resume = _smoke_render_copy(tmp, "resume", pretrain_model=model_dir, **dict(over, total_epochs=2))
        t1 = time.perf_counter()
        entry.main(["--config_json", resume])
        out["one_rank_resume_seconds"] = time.perf_counter() - t1
        rlog = _read_log(os.path.join(tmp, "resume"))
        check([x["epoch"] for x in rlog if "train_loss" in x] == [1], "the 1-rank resume trained epoch 1")
    print("trainer at 2 ranks (smoke_render, gloo, one card): " + json.dumps(out))
    print(f"phase trainer at 2 ranks: {time.perf_counter() - t0:.1f} s")
    return out


# phases 29-30: HRNet's steps. tests/test_torch_hrnet_slice.py holds the
# port's encoder gradients against JAX's within 30x JAX's own one-ulp move
# and 5e-2 at most; the card against the CPU is held to the same cap
HRNET_GRAD_TOL = 5e-2
# phase 31: the loss set JAX's step runs with four channels. Its
# photometric terms compare the 3-channel render with the 4-channel images
# and raise (tests/test_torch_four_channel.py), so the batch holds no
# segms_gt or texture_con, and sil and iou, which read segms_gt, are out;
# no loss reads the render, so the train step launches K1 and K2, no K3
FOUR_LOSSES = tuple(k for k in LOSSES if k not in ("sil", "iou")) + ("open_2dj",)
FOUR_PATH = ("K1 msaa_raster", "K2 gather_rows")
# ResNet's tensors below layer4_0.bn1, whose train-mode BatchNorm backward
# over 8 x 2 x 2 values per channel at 32 px adds a ~1.2e-3 relative
# difference (tests/test_torch_four_channel.py)
FOUR_CHANNEL_STEM_SIDE = ("encoder.backbone.conv1", "encoder.backbone.bn1", "encoder.backbone.layer1_",
                          "encoder.backbone.layer2_", "encoder.backbone.layer3_",
                          "encoder.backbone.layer4_0.conv1", "encoder.backbone.layer4_0.bn1.bias")
FOUR_CHANNEL_STEM_TOL = 2e-3


def four_channel_batch(batch: dict, seed: int = 5) -> dict:
    """`batch` without its photometric targets, with seeded openpose
    detections and their heatmap channel appended to the images, as the
    port's FreiHAND loader appends it (data/freihand.py::
    keypoint_heatmap_channel)."""
    from hifihr_tpu_torch.data.freihand import keypoint_heatmap_channel

    out = {k: v for k, v in with_openpose(batch, seed).items() if k not in ("segms_gt", "texture_con")}
    size = out["imgs"].shape[1]
    hm = np.stack([keypoint_heatmap_channel(j, size) for j in out["open_2dj"].cpu().numpy()])[..., None]
    out["imgs"] = torch.cat([out["imgs"], torch.tensor(hm, device=out["imgs"].device)], dim=-1)
    return out


OPENPOSE_B, OPENPOSE_S = 16, 368  # the detector's batch and image size (openpose_hand.py's default)
OPENPOSE_CHECK_S = 64  # its card-against-CPU check


def phase_openpose() -> dict:
    """Phase 32: the CPM hand detector (seeded init, no CPM weights in the
    repo) on 16 images at 368^2 over its 4 scales, and the card against the
    CPU at 64^2: peaks equal, confidences within 1e-4 of the largest. No
    TPU kernel runs: every kernel's count stays 0."""
    from hifihr_tpu_torch.networks.openpose_hand import HandDetector

    t0 = time.perf_counter()
    rng = np.random.RandomState(7)
    small = rng.rand(4, OPENPOSE_CHECK_S, OPENPOSE_CHECK_S, 3).astype(np.float32)
    gpu = HandDetector(image_size=OPENPOSE_CHECK_S, device="cuda", seed=0)
    cpu = HandDetector(image_size=OPENPOSE_CHECK_S, device="cpu", seed=0)
    (gp, gc), (cp, cc) = gpu(small), cpu(small)
    conf_err = float(np.abs(gc - cc).max() / np.abs(cc).max())
    print(f"openpose detector card vs CPU ({small.shape[0]} images, {OPENPOSE_CHECK_S}^2): peaks equal "
          f"{bool((gp == cp).all())}, confidence max rel err {conf_err}")
    check(np.array_equal(gp, cp), "the detector's peaks on the card equal the CPU's")
    check(conf_err <= 1e-4, "the detector's confidences within 1e-4 of the CPU's")

    det = HandDetector(image_size=OPENPOSE_S, device="cuda", seed=0)
    imgs = torch.tensor(rng.rand(OPENPOSE_B, OPENPOSE_S, OPENPOSE_S, 3).astype(np.float32), device="cuda")
    det.infer(imgs)
    torch.cuda.synchronize()
    reset_launches()
    peaks, conf = det.infer(imgs)
    torch.cuda.synchronize()
    launches = read_launches()
    check(not any(launches.values()), f"no TPU kernel on the detector's path: {launches}")
    check(bool(torch.isfinite(conf).all()) and peaks.shape == (OPENPOSE_B, 21, 2)
          and bool(((peaks >= 0) & (peaks < OPENPOSE_S)).all()), "peaks inside the image, finite confidences")
    ms = time_ms(lambda: det.infer(imgs), reps=2)
    busy, dev_launches = device_profile(lambda: det.infer(imgs))
    numbers = {"batch": OPENPOSE_B, "image_size": OPENPOSE_S, "scales": list(det.scales), "ms": ms,
               "images_per_s": OPENPOSE_B / ms * 1e3, "device_busy_ms": busy, "launches_per_batch": dev_launches,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("openpose detect: " + json.dumps(numbers))
    print(f"phase openpose: {time.perf_counter() - t0:.1f} s")
    return launches


def phase_demo(tmp: str) -> tuple:
    """Phase 33: hifihr_tpu_torch.demo on a PNG the phase writes (the
    flagship batch's first image), restoring a checkpoint the phase's
    CheckpointManager wrote (the flagship model at seed 1; the demo builds
    seed 0, so the restore matters): demo.main whole where matplotlib
    imports, else its own steps (the forward, save_obj, the turntable,
    write_png) and no panel. Checks: the OBJ's 778 vertices and 1538 faces
    equal to the restored model's mesh, 8 turntable frames each with a
    silhouette; every frame's K1 route (2 x 2 subsamples) exactly equal to
    msaa_select_plain(..., samples=2) and timed against its bound, every
    K2 launch bit-equal. Returns (the launches of the whole demo, K1's
    turntable reading)."""
    from hifihr_tpu_torch import demo
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.checkpoint import CheckpointManager
    from hifihr_tpu_torch.training.train_state import create_train_state
    from hifihr_tpu_torch.utils import visualize

    t0 = time.perf_counter()
    cfg = demo.load_config(None)
    saved = build_model(cfg, device="cuda", seed=1)
    CheckpointManager(os.path.join(tmp, "model"), cfg.save_mode).save(create_train_state(saved, cfg), 0)
    image = os.path.join(tmp, "hand.png")
    visualize.write_png(image, flagship_batch("cpu")["imgs"][0].numpy())
    out_dir = os.path.join(tmp, "demo_out")
    try:
        import matplotlib  # noqa: F401

        panel = True
    except ImportError:
        panel = False
    reset_launches()
    with captured_kernel_inputs() as got:
        if panel:
            res = demo.main(["--image", image, "--checkpoint", os.path.join(tmp, "model"), "--out", out_dir])
            verts, frames = res["verts"], res["frames"]
        else:  # the demo's own steps, the panel left out
            model = build_model(cfg, device="cuda", seed=0)
            CheckpointManager(os.path.join(tmp, "model"), cfg.save_mode).restore(create_train_state(model, cfg))
            K, root = demo.demo_camera(cfg.image_size, "cuda")
            imgs = torch.as_tensor(demo.load_input(image, cfg.image_size)[None], device="cuda")
            os.makedirs(out_dir, exist_ok=True)
            verts, faces = demo.write_mesh(out_dir, model, demo.forward(model, imgs, K, root), root)
            frames = demo.write_turntable(out_dir, verts, faces, "cuda")
        torch.cuda.synchronize()
    launches = read_launches()
    check_route_launches(launches, "the demo")
    print(f"demo launches: {launches}; panel {'drawn' if panel else 'not drawn: matplotlib is not installed'}")
    check(launches["K1 msaa_raster"] == 9 and launches["K2 gather_rows"] == 9 and launches["K3 scatter_rows"] == 0
          and launches["K4 face_raster"] == 0, "K1 and K2 once for the forward and once per turntable frame")

    K, root = demo.demo_camera(cfg.image_size, "cuda")
    imgs = torch.as_tensor(demo.load_input(image, cfg.image_size)[None], device="cuda")
    want = demo.forward(saved, imgs, K, root)
    check(np.allclose(verts, (want["mano_verts"][0] + root[0]).cpu().numpy(), atol=1e-6),
          "the demo's mesh is the restored model's")
    with open(os.path.join(out_dir, "hand.obj")) as f:
        lines = f.read().splitlines()
    n_v, n_f = sum(x.startswith("v ") for x in lines), sum(x.startswith("f ") for x in lines)
    check((n_v, n_f) == (778, 1538), f"hand.obj holds 778 vertices and 1538 faces ({n_v}, {n_f})")
    covered = [float((f[..., 3] > 0).mean()) for f in frames]
    check(frames.shape == (8, 224, 224, 4) and min(covered) > 0, f"8 turntable frames with a silhouette: {covered}")
    check(os.path.getsize(os.path.join(out_dir, "turntable.png")) > 0, "turntable.png written")
    check(not panel or os.path.getsize(os.path.join(out_dir, "panel.png")) > 0, "panel.png written")

    samples = [k[3] for k in got["K1"]]
    check(samples == [3] + [2] * 8, f"K1 at 3 x 3 in the forward, at 2 x 2 on each frame: {samples}")
    frames_k1 = [k1_route(coef, bbox, f"turntable frame {i}", size, samples=n)
                 for i, (coef, bbox, size, n) in enumerate(got["K1"][1:])]
    k2_checked = check_k2_captures(got["K2"], "the demo")
    reading = {"frames": len(frames_k1), "launches_per_frame": 1,
               "ms": statistics.median(r["route_ms"] for r in frames_k1),
               "bound_ms": statistics.median(r["bound_ms"] for r in frames_k1),
               "covered": covered, "per_frame": frames_k1}
    coef, bbox, size, n = got["K1"][1]
    from hifihr_tpu_torch.render import raster_msaa as k1

    reading["plain_ms"] = time_ms(lambda: k1.msaa_select_plain(coef, size, n), reps=1)
    print(f"K1 at 2 x 2 on the turntable: median {reading['ms']:.4f} ms a frame (plain {reading['plain_ms']:.2f}), "
          f"bound {reading['bound_ms']:.4f}; K2 {k2_checked} launches bit-equal")
    print(f"phase demo: {time.perf_counter() - t0:.1f} s")
    return launches, reading


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few eval and train steps of each cell")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hifihr_tpu_torch import kernels
    from hifihr_tpu_torch.config import Config

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
    t0 = time.perf_counter()
    table = phase_kernels(batch) + [phase_k4(batch)]
    print(f"phase kernels K1-K4: {time.perf_counter() - t0:.1f} s")
    phase_ssim()
    small = slice_batch()
    launches, hands = {}, {}

    def cell(key: str, label: str, cfg, eval_batch: dict, train_batch: dict, eval_check: tuple,
             train_check: tuple, fired: tuple = FIRED, train_path: tuple | None = None) -> None:
        """The eval and train steps of one cell; their launches under
        `{key}eval_step` and `{key}train_step`."""
        launches[f"{key}eval_step"] = phase_eval_step(eval_batch, args.profile, cfg, label, *eval_check)
        launches[f"{key}train_step"], hands[key] = phase_train_step(train_batch, args.profile, cfg, label, fired,
                                                                    *train_check, path=train_path)

    def full_size_check(cfg) -> tuple:  # the eval step in fp32 on 2 images at 224^2
        return (dataclasses.replace(cfg, compute_dtype="float32"), {k: v[:2].cpu() for k, v in batch.items()},
                f"{cfg.pretrain}, {S} px, 2 images")

    def small_check(**over) -> tuple:  # the slice tests' configuration
        cfg = Config(**dict(SLICE_CFG, **over))
        return cfg, slice_batch(size=cfg.image_size), f"{cfg.pretrain}, {cfg.image_size} px, 8 images"

    flagship = step_config()
    cell("", "mano msaa", flagship, batch, batch, full_size_check(flagship), small_check()[:2])
    ssaa_batch = {k: v[:SSAA_B] for k, v in batch.items()}
    ssaa_small = small_check(aa_mode="ssaa")
    cell("ssaa_", "mano ssaa", step_config("ssaa"), ssaa_batch, ssaa_batch, ssaa_small, ssaa_small[:2])
    t0 = time.perf_counter()
    nimble = phase_nimble_kernels(batch)
    print(f"phase NIMBLE kernels: {time.perf_counter() - t0:.1f} s")
    nimble_small = small_check(hand_model="nimble")
    cell("nimble_", "nimble msaa", step_config(hand_model="nimble"), batch, batch, nimble_small, nimble_small[:2])
    # bench's effb3 cell (bench.py:274-275); its train step held at 64 px
    effb3 = step_config(pretrain="effb3")
    cell("effb3_", "effb3 msaa", effb3, batch, batch, full_size_check(effb3),
         small_check(pretrain="effb3", image_size=64)[:2])
    # the paper's config from its JSON, at its own val and train batches
    paper = Config.from_json(PAPER_CONFIG)
    paper_small = (Config.from_json(PAPER_CONFIG, **PAPER_SMALL), {k: v for k, v in small.items() if k in PAPER_KEYS})
    cell("paper_", "paper (nimble effb3) msaa", paper, paper_batch(batch, paper.val_batch),
         paper_batch(batch, paper.train_batch), paper_small + ("the paper config, 32 px, 8 images",), paper_small,
         fired=paper.losses)

    # phase 19: mano_new's steps (no TPU kernel on its path)
    launches.update(phase_mano_new(batch, args.profile))
    # phase 21: NIMBLE's per-fragment UV render (MSAA), and K2 and K3 on its texture quad
    uv_cfg = dataclasses.replace(step_config(hand_model="nimble"), nimble_corner_tex=False)
    uv_small = small_check(hand_model="nimble", nimble_corner_tex=False)
    cell("nimble_uv_", "nimble uv msaa", uv_cfg, batch, batch, uv_small, uv_small[:2])
    quad = {"nimble_uv": texture_quad(uv_cfg, batch, "the NIMBLE UV train step")}
    # phase 22: NIMBLE under SSAA (K4 at 11,926 faces on NIMBLE's own hands)
    nimble_ssaa = step_config("ssaa", "nimble")
    nimble_ssaa_small = small_check(hand_model="nimble", aa_mode="ssaa")
    cell("nimble_ssaa_", "nimble ssaa", nimble_ssaa, ssaa_batch, ssaa_batch, nimble_ssaa_small,
         nimble_ssaa_small[:2])
    quad["nimble_ssaa"] = texture_quad(nimble_ssaa, ssaa_batch, "the NIMBLE SSAA train step")

    # phase 27: the rgb2hm branch (the flagship plus the hourglass and its
    # five losses) at 224^2, eval and train at batch 64
    hm_cfg = dataclasses.replace(flagship, rgb2hm=True, losses=LOSSES + HM_LOSSES)
    hm_small = small_check(rgb2hm=True, losses=LOSSES + HM_LOSSES)
    hm_small = (hm_small[0], with_openpose(hm_small[1]), hm_small[2])
    hm_batch = with_openpose(batch)
    cell("rgb2hm_", "rgb2hm msaa", hm_cfg, hm_batch, hm_batch, full_size_check(hm_cfg), hm_small[:2],
         fired=FIRED + HM_LOSSES)
    # phases 29-30: HRNet-W18-small-v2, the flagship with pretrain="hr18sv2"
    # (1024 features, no light estimator: HRNet has no low-level tap)
    hrnet = step_config(pretrain="hr18sv2")
    cell("hrnet_", "hrnet msaa", hrnet, batch, batch, full_size_check(hrnet), small_check(pretrain="hr18sv2")[:2])
    # phase 31: the four-channel input (the images and the openpose
    # heatmap), under the loss set JAX's step runs with four channels
    fc = dataclasses.replace(flagship, four_channel=True, losses=FOUR_LOSSES)
    fc_batch = four_channel_batch(batch)
    fc_small = small_check(four_channel=True, losses=FOUR_LOSSES)
    fc_small_batch = four_channel_batch(fc_small[1])
    cell("four_channel_", "four_channel msaa", fc, fc_batch, fc_batch,
         (dataclasses.replace(fc, compute_dtype="float32"), {k: v[:2].cpu() for k, v in fc_batch.items()},
          f"res50, four channels, {S} px, 2 images"), (fc_small[0], fc_small_batch), fired=FOUR_LOSSES,
         train_path=FOUR_PATH)
    # phase 32: the CPM hand detector; phase 33: the demo, its turntable K1 at 2 x 2
    launches["openpose"] = phase_openpose()
    import tempfile

    with tempfile.TemporaryDirectory(prefix="hifihr_demo_") as tmp:
        launches["demo"], turntable = phase_demo(tmp)

    # phases 24-26: the flagship train step over two ranks, a process group
    # of one rank under NCCL, 1 rank against 2
    multi = {"dp_train": phase_dp_flagship(), "nccl_world1": phase_nccl_world1(), "invariance": phase_invariance()}

    # phase 17: the Trainer through the entry, on configs/smoke_render.json
    trainer = phase_trainer(launches)
    # phase 18: the paper config through the entry, from a FreiHAND-format
    # tree; phase 20: mano_new through the entry from the same tree
    trainer.update(phase_real_data(launches))
    # phase 23: test-time MANO fitting in the Trainer's eval
    fitting = phase_fitting()
    # phase 28: the Trainer at 2 ranks through the entry
    multi["trainer_two_ranks"] = phase_trainer_two_ranks()

    table[0]["train_hand"] = hands[""]["K1"] + hands["ssaa_"]["K1"] + hands["effb3_"]["K1"]
    table[2]["train_hand"] = hands[""]["K3"] + hands["ssaa_"]["K3"] + hands["effb3_"]["K3"]
    table[3]["train_hand"] = hands["ssaa_"]["K4"]
    nimble["K1"]["train_hand"] = hands["nimble_"]["K1"] + hands["paper_"]["K1"]
    nimble["K3"]["train_hand"] = hands["nimble_"]["K3"] + hands["paper_"]["K3"]
    # the new cells: K4 on NIMBLE's own SSAA hands, K1 and K3 on the UV steps'
    # inputs, K2 and K3 on the texture quad
    table[3]["nimble_ssaa_hand"] = hands["nimble_ssaa_"]["K4"]
    table[0]["nimble_uv_hand"] = hands["nimble_uv_"]["K1"]
    table[2]["nimble_uv_hand"] = hands["nimble_uv_"]["K3"]
    table[2]["nimble_ssaa_hand"] = hands["nimble_ssaa_"]["K3"]
    # PR 13's cells: K1 and K3 on the HRNet and four-channel steps' inputs,
    # K1 at 2 x 2 on the demo's turntable
    table[0]["hrnet_hand"] = hands["hrnet_"]["K1"]
    table[2]["hrnet_hand"] = hands["hrnet_"]["K3"]
    table[0]["four_channel_hand"] = hands["four_channel_"]["K1"]
    table[0]["turntable_2x2"] = turntable
    for key, q in quad.items():
        table[1][f"texture_quad_{key}"] = dict(q["K2"], **q["sample"])
        table[2][f"texture_quad_{key}"] = q["K3"]
    k2_checked = sum(h["K2"] for h in hands.values())
    print(f"K2: {k2_checked} captured launches of the train steps bit-equal to the plain version")
    for k, reading in zip(table, (nimble["K1"], nimble["K2"], nimble["K3"], None)):
        name = k["name"]
        # `launches`: the path's own step (K1 and K2 the eval step, K3 the
        # train step, K4 the SSAA eval step); every cell's under its key
        k["launches"] = launches["ssaa_eval_step" if name.startswith("K4") else
                                 "train_step" if name.startswith("K3") else "eval_step"][name]
        k["launches_train_step"] = launches["ssaa_train_step" if name.startswith("K4") else "train_step"][name]
        for cell_step, counts in launches.items():
            if cell_step not in ("eval_step", "train_step"):
                k[f"launches_{cell_step}"] = counts[name]
        for step_key, counts in trainer.items():
            k[f"launches_{step_key}"] = counts[name]
        if reading is not None:
            k["nimble"] = reading
    print("test-time fitting (no TPU kernel): " + json.dumps(fitting))
    print("multi-rank training: " + json.dumps({k: v for k, v in multi.items() if k != "trainer_two_ranks"}))
    for k in table:  # K1, K2 and K3 on each dp rank per step (phase 24)
        k["launches_dp_train_step_per_rank"] = [r[k["name"]] for r in
                                                multi["dp_train"]["gloo_one_card"]["kernel_launches_per_rank"]]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
