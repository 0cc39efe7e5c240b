"""The traffic's inputs, made from the seed on the device: posed MANO hands
placed before a pinhole camera, their FreiHAND joints, 2D joints, vertices
and silhouettes, and images of the hand over a smooth background.

Every target a configuration's losses read comes from the one posed mesh, so
every listed loss term fires and is nonzero: the GT mask is the mesh's own
silhouette (K1's plain version in the reference, coverage > 0). The hand's
parameters and the camera come from the traffic file's `scene` block.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from benchmark.reference.geometry.projection import perspective_project
from benchmark.reference.hand.mano import ManoLayer, regress_joints_frei
from benchmark.reference.render.raster import project_to_screen
from benchmark.reference.render.raster_msaa import rasterize_msaa

ROOT_ID = 9  # FreiHAND middle MCP, the root the steps centre on


def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def _axis_angle(gen, n, max_deg, device):
    axis = Fn.normalize(torch.randn(n, 3, generator=gen, device=device), dim=-1)
    return axis * _uniform(gen, n, 0.0, math.radians(max_deg), device)[:, None]


@torch.no_grad()
def posed_hands(n: int, size: int, scene: dict, gen: torch.Generator, device, chunk: int = 256) -> dict:
    """n posed hands: {imgs (n, S, S, 3) uint8, Ks, root_xyz, joints, j2d_gt,
    verts, segms_gt (n, S, S) float {0, 1}, scales, texture_con}, on
    `device`. Drawn in one order whatever n is cut into chunks."""
    mano = ManoLayer(ncomps=45).to(device)
    pose = torch.cat([_axis_angle(gen, n, scene["global_rot_deg"], device),
                      torch.randn(n, 45, generator=gen, device=device) * scene["pose_std"]], dim=1)
    beta = torch.randn(n, 10, generator=gen, device=device) * scene["shape_std"]
    depth = _uniform(gen, n, *scene["root_depth_m"], device)
    offset = (torch.rand(n, 2, generator=gen, device=device) * 2 - 1) * scene["root_offset"]
    focal = _uniform(gen, n, *scene["focal_px"], device)
    K = torch.zeros(n, 3, 3, device=device)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = focal, focal, size / 2, size / 2, 1.0
    # a smooth background from coarse noise, and a skin tone with fine noise
    coarse = torch.rand(n, 3, 8, 8, generator=gen, device=device)
    tone = torch.tensor(scene["skin_rgb"], device=device) + 0.1 * torch.randn(n, 3, generator=gen, device=device)
    grain = 0.05 * torch.randn(n, size, size, 3, generator=gen, device=device)
    faces = torch.as_tensor(mano.faces_np, dtype=torch.int64, device=device)
    out = {k: [] for k in ("verts", "joints", "mask")}
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        verts = mano(pose[a:b], beta[a:b]).verts
        joints = regress_joints_frei(verts, mano.J_regressor)
        # the root joint at (offset * depth, depth) in the camera
        root = torch.cat([offset[a:b] * depth[a:b, None], depth[a:b, None]], dim=-1)[:, None]
        shift = root - joints[:, ROOT_ID:ROOT_ID + 1]
        verts, joints = verts + shift, joints + shift
        _, cover, _ = rasterize_msaa(project_to_screen(verts, K[a:b]), faces, size, samples=3)
        out["verts"].append(verts)
        out["joints"].append(joints)
        out["mask"].append((cover > 0).float())
    verts, joints, mask = (torch.cat(out[k]) for k in ("verts", "joints", "mask"))
    background = Fn.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    hand = (tone[:, None, None, :] + grain).clamp(0, 1)
    img = torch.where(mask[..., None] > 0, hand, background)
    root_xyz = joints[:, ROOT_ID:ROOT_ID + 1]
    return {
        "imgs": (img * 255).round().to(torch.uint8),
        "Ks": K, "root_xyz": root_xyz, "joints": joints,
        "j2d_gt": perspective_project(joints, K), "verts": verts, "segms_gt": mask,
        "scales": torch.linalg.vector_norm(joints[:, 9] - joints[:, 10], dim=-1),
        "texture_con": torch.ones(n, device=device),
    }


def split_batches(hands: dict, batch: int, keys: tuple) -> list[dict]:
    """The pool: consecutive rows of `hands` cut into batches of `batch`,
    with `keys` only (the configuration's batch keys)."""
    n = hands["imgs"].shape[0] // batch
    return [{k: hands[k][i * batch:(i + 1) * batch].contiguous() for k in keys} for i in range(n)]
