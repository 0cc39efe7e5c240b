"""DART synthetic dataset loader (counterpart of hifihr_tpu/data/dart.py:
the same samples, byte for byte, but for `manos`, whose root rotation goes
through the port's torch rotations and differs from JAX's by float32
rounding).

Mirrors the reference's data/dataset.py DARTset (:1630-1790) + DARTset_utils:
  * part_*.pkl records (pose [16,3] UNITY axis-angle, joint3d, joint2d, img)
  * UNITY -> camera coords: negate y,z of joints/verts; root rotation
    conjugated by diag(1,-1,-1); non-root pose gets the MANO mean added
  * joints reordered to FreiHAND order via the DART reorder table
  * least-squares fitted orthographic camera [f, tx, ty] per sample
  * mask from the RGBA alpha channel; images resized to 224.

examples schema: imgs, ortho_intr, joints, j2d_gt, verts, segms_gt, manos.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

import torch

from hifihr_tpu_torch.assets import load_mano_model
from hifihr_tpu_torch.data.freihand import _load_image
from hifihr_tpu_torch.geometry import crops
from hifihr_tpu_torch.geometry.rotations import axis_angle_to_matrix, matrix_to_axis_angle

RAW_IMAGE_SIZE = 512
OUT_RES = 224
# DART joint reorder -> FreiHAND order (reference data/dataset.py:1656)
REORDER = np.asarray(
    [0, 13, 14, 15, 20, 1, 2, 3, 16, 4, 5, 6, 17, 10, 11, 12, 19, 7, 8, 9, 18]
)
UNITY2CAM = np.diag([1.0, -1.0, -1.0]).astype(np.float32)


def fit_ortho_param(joints3d: np.ndarray, joints2d: np.ndarray) -> np.ndarray:
    """Least-squares [f, tx, ty] with u = f*x + tx, v = f*y + ty
    (reference utils/DARTset_utils.py:75-88)."""
    xy = joints3d[:, :2].reshape(-1)[:, None]
    uv = joints2d.reshape(-1)[:, None]
    pad2 = (np.arange(uv.shape[0]) % 2)[:, None].astype(np.float64)
    pad1 = 1 - pad2
    jM = np.concatenate([xy, pad1, pad2], axis=1)
    sol = np.linalg.inv(jM.T @ jM) @ (jM.T @ uv)
    return sol.reshape(-1).astype(np.float32)


class DARTset:
    name = "Dart"

    def __init__(self, base_path: str, split: str = "train", use_full_wrist: bool = False):
        self.root = os.path.join(base_path, "DARTset",
                                 "train" if split in ("train", "training") else "test")
        self.use_full_wrist = use_full_wrist
        self.mano_pose_mean = load_mano_model().hands_mean.reshape(-1)

        self.image_paths: list[str] = []
        self.raw_mano: list[np.ndarray] = []
        self.joints_3d: list[np.ndarray] = []
        self.joints_2d: list[np.ndarray] = []
        self.verts_paths: list[str] = []
        parts = sorted(
            r for r in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, r))
            and "verts" not in r and "wbg" not in r
        )
        for part in parts:
            with open(os.path.join(self.root, f"part_{part}.pkl"), "rb") as f:
                rec = pickle.load(f)
            img_dir = os.path.join(self.root, part)
            for k in range(len(rec["pose"])):
                self.image_paths.append(os.path.join(img_dir, rec["img"][k]))
                self.raw_mano.append(np.asarray(rec["pose"][k], np.float32))
                self.joints_3d.append(np.asarray(rec["joint3d"][k], np.float32))
                self.joints_2d.append(np.asarray(rec["joint2d"][k], np.float32))
                self.verts_paths.append(
                    os.path.join(img_dir + "_verts", rec["img"][k].replace(".png", ".pkl"))
                )

    def __len__(self) -> int:
        return len(self.image_paths)

    def _joints3d(self, idx: int) -> np.ndarray:
        j = self.joints_3d[idx].copy()
        j[:, 1:] = -j[:, 1:]
        j = j[REORDER]
        return j + np.asarray([0, 0, 0.5], np.float32)

    def _joints2d(self, idx: int) -> np.ndarray:
        j2d = self.joints_2d[idx].copy()[REORDER]
        return j2d / RAW_IMAGE_SIZE * OUT_RES

    def get_sample(self, idx: int) -> dict:
        joints = self._joints3d(idx)
        j2d = self._joints2d(idx)
        ortho = fit_ortho_param(joints, j2d)

        rgba_path = self.image_paths[idx]
        rgba = _load_image(rgba_path, as_u8=True)
        # resize to 224 by the bilinear crop warp
        img = crops.resized_crop(
            rgba[..., :3], 0, 0, rgba.shape[0], rgba.shape[1],
            [OUT_RES, OUT_RES], out_u8=True
        )
        mask = None
        if rgba.shape[-1] == 4:
            alpha = crops.resized_crop(
                rgba[..., 3], 0, 0, rgba.shape[0], rgba.shape[1], [OUT_RES, OUT_RES]
            )
            mask = (alpha >= 0.5).astype(np.uint8)

        pose = self.raw_mano[idx]
        root_rot = UNITY2CAM @ axis_angle_to_matrix(torch.from_numpy(pose[0])).numpy()
        root_aa = matrix_to_axis_angle(torch.from_numpy(root_rot[None]))[0].numpy()
        mano_pose = np.concatenate(
            [np.asarray(root_aa).reshape(-1), pose[1:].reshape(-1) + self.mano_pose_mean]
        ).astype(np.float32)

        sample = {
            "imgs": img,  # uint8; normalised on device
            "ortho_intr": ortho,
            "joints": joints.astype(np.float32),
            "j2d_gt": j2d.astype(np.float32),
            "manos": mano_pose,
            "root_xyz": joints[9:10].astype(np.float32),
            "idxs": np.int64(idx),
        }
        if mask is not None:
            sample["segms_gt"] = mask
        verts_path = self.verts_paths[idx]
        if os.path.exists(verts_path):
            with open(verts_path, "rb") as f:
                verts = np.asarray(pickle.load(f), np.float32)
            verts[:, 1:] = -verts[:, 1:]
            verts = verts + joints[5]
            if not self.use_full_wrist:
                verts = verts[:778]
            sample["verts"] = verts
        return sample
