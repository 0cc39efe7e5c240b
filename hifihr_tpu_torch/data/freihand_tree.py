"""Write a FreiHAND-format tree to disk (the port's counterpart of
tools/make_freihand_fixture.py), so the real loader path (JPEG decode ->
affine warp -> collate -> pinned copy) runs without the FreiHAND download.

It writes the layout `FreiHand.__init__` reads (data/freihand.py; the
reference's data/dataset.py:1402-1610): {training,evaluation}_K.json,
{training,evaluation}_scale.json, {training,evaluation}_xyz.json,
training_verts.json, training/{rgb,mask}/%08d.jpg,
evaluation/{rgb,mask}/%08d.jpg and
outputs/freihand-train_openpose_keypoints.json. It writes no
evaluation_verts.json (3,960 x 778 x 3 numbers in JSON), so the Trainer's
eval reports no PA-MPJPE on it.

The geometry is the port's SyntheticHandDataset (MANO joints and vertices, a
perspective K, j2d = proj(joints, K), openpose labels = j2d at confidence 1).
The pixels come from numpy alone, from the seed: smooth low-frequency noise
(14 x 14 noise upsampled bilinearly) with a bright square at the hand, and a
binary mask of that square, all at 224^2. Pillow encodes them as JPEG at
quality 92. Only `distinct`
frames are encoded; frame i of either split is a hard link to frame
i % distinct (its geometry repeats with it), so a tree of thousands of
frames costs a few dozen encodes. As in FreiHAND, training/rgb holds 4
colour versions of each of the n_train frames (image v * n_train + i shows
frame i), training/mask one mask per frame, and the openpose labels one
entry per image.

    python -m hifihr_tpu_torch.data.freihand_tree OUT_DIR [N_TRAIN] [N_EVAL]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from hifihr_tpu_torch.data.freihand import N_COLOR_VERSIONS

SIZE = 224  # FreiHAND's frames (and the loader's train crop)
QUALITY = 92  # Pillow's JPEG quality

def _upsample(low: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of (h, w, c) to (size, size, c), half-pixel centres."""
    def axis(n_in: int):
        x = np.clip((np.arange(size) + 0.5) * n_in / size - 0.5, 0, n_in - 1)
        x0 = np.minimum(np.floor(x).astype(int), n_in - 2)
        return x0, (x - x0)

    y0, fy = axis(low.shape[0])
    x0, fx = axis(low.shape[1])
    rows = low[y0] * (1 - fy)[:, None, None] + low[y0 + 1] * fy[:, None, None]
    return rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x0 + 1] * fx[None, :, None]


def source_frames(distinct: int, seed: int = 0) -> dict:
    """The tree's distinct frames before encoding: images (n, s, s, 3) and
    masks (n, s, s) uint8, and their geometry (K, joints and verts in camera
    space, j2d, scales)."""
    from hifihr_tpu_torch.data.synthetic import SyntheticHandDataset

    ds = SyntheticHandDataset(size=distinct, image_size=SIZE, seed=seed)
    rng = np.random.RandomState(seed + 7)
    s = SIZE
    images = np.empty((distinct, s, s, 3), np.uint8)
    masks = np.zeros((distinct, s, s), np.uint8)
    xyz, verts, j2d, scales = [], [], [], []
    for i in range(distinct):
        root = np.asarray([0.0, 0.0, ds.root_z[i]], np.float32)
        joints_cam = ds.joints[i] + root
        uvw = joints_cam @ ds.K.T
        uv = uvw[:, :2] / uvw[:, 2:3]
        img = _upsample(rng.rand(14, 14, 3) * 255, s)
        cx, cy = np.clip(uv.mean(0).astype(int), 16, s - 16)
        img[cy - 16:cy + 16, cx - 16:cx + 16] = img[cy - 16:cy + 16, cx - 16:cx + 16] * 0.3 + 0.7 * 230
        images[i] = np.clip(img + 0.5, 0, 255).astype(np.uint8)
        masks[i, cy - 16:cy + 16, cx - 16:cx + 16] = 255
        xyz.append(joints_cam)
        verts.append(ds.verts[i] + root)
        j2d.append(uv)
        scales.append(float(np.linalg.norm(ds.joints[i][9] - ds.joints[i][10])))
    return {"images": images, "masks": masks, "K": ds.K, "xyz": np.stack(xyz), "verts": np.stack(verts),
            "j2d": np.stack(j2d), "scales": np.asarray(scales)}


def write_freihand_tree(out_dir: str, n_train: int, n_eval: int = 3960, distinct: int = 48,
                        seed: int = 0) -> dict:
    """Write the tree under `out_dir` and return `source_frames`' arrays
    (the pixels each linked frame was encoded from: frame i has
    images[i % distinct])."""
    from PIL import Image

    distinct = min(distinct, max(n_train, n_eval))
    src = source_frames(distinct, seed)
    enc_dir = os.path.join(out_dir, "encoded")
    os.makedirs(enc_dir, exist_ok=True)
    for i in range(distinct):
        Image.fromarray(src["images"][i]).save(os.path.join(enc_dir, "rgb_%04d.jpg" % i), quality=QUALITY)
        Image.fromarray(src["masks"][i]).save(os.path.join(enc_dir, "mask_%04d.jpg" % i), quality=QUALITY)
    for split, kind, n, n_frames in (("training", "rgb", n_train * N_COLOR_VERSIONS, n_train),
                                     ("training", "mask", n_train, n_train),
                                     ("evaluation", "rgb", n_eval, n_eval), ("evaluation", "mask", n_eval, n_eval)):
        d = os.path.join(out_dir, split, kind)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            os.link(os.path.join(enc_dir, "%s_%04d.jpg" % (kind, i % n_frames % distinct)),
                    os.path.join(d, "%08d.jpg" % i))

    def per_frame(a, n):
        return [a[i % distinct] for i in range(n)]

    K = np.asarray(src["K"], np.float64).tolist()
    files = {
        "training_K": [K] * n_train,
        "training_scale": per_frame(src["scales"].tolist(), n_train),
        "training_xyz": per_frame(src["xyz"].astype(np.float64).tolist(), n_train),
        "training_verts": per_frame(src["verts"].astype(np.float64).tolist(), n_train),
        "evaluation_K": [K] * n_eval,
        "evaluation_scale": per_frame(src["scales"].tolist(), n_eval),
        "evaluation_xyz": per_frame(src["xyz"].astype(np.float64).tolist(), n_eval),
    }
    for name, data in files.items():
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(data, f)
    os.makedirs(os.path.join(out_dir, "outputs"), exist_ok=True)
    ones = np.ones((21, 1)).tolist()
    with open(os.path.join(out_dir, "outputs", "freihand-train_openpose_keypoints.json"), "w") as f:
        # indexed by image, as in FreiHAND: one entry per colour version
        labels = per_frame([[j.astype(np.float64).tolist(), ones] for j in src["j2d"]], n_train)
        json.dump(labels * N_COLOR_VERSIONS, f)
    return src


if __name__ == "__main__":
    out = sys.argv[1]
    n_train = int(sys.argv[2]) if len(sys.argv) > 2 else 480
    n_eval = int(sys.argv[3]) if len(sys.argv) > 3 else 3960
    write_freihand_tree(out, n_train, n_eval)
    print(f"FreiHAND-format tree at {out}: {n_train} training and {n_eval} evaluation frames")
