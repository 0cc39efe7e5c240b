"""RHD (Rendered Handpose Dataset) loader (counterpart of
hifihr_tpu/data/rhd.py: the same samples, byte for byte).

Mirrors the reference's data/dataset.py RHD branch (:291-630 active code) + the RHD
class (:1809-1926) + data_dic normalisation (traineval_util.py:207-250):
  * side selection: hand with more visible joints wins, ties broken by mask
    pixel count (:329-344)
  * left hands flipped to right: image mirrored, x3d negated, u2d mirrored
  * crop around joint 12 (RHD middle fingertip region) sized to
    3x max joint extent, clamped [50, 500] px, with train-time scale noise
    in [0.9, 1.0]; K updated as K_crop = T @ S @ K (:571-629)
  * keypoint_scale = |j12 - j11| index root bone length
  * outputs already remapped to FreiHAND joint order.

Output schema: the train step's batch keys (imgs uint8 HWC, Ks, joints,
j2d_gt, scales, segms_gt, uv_vis, sides, root_xyz, idxs).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from hifihr_tpu_torch.data.freihand import _load_image
from hifihr_tpu_torch.geometry import crops
from hifihr_tpu_torch.geometry.joints import RHD_TO_FREI

RAW_RES = 320
OUT_RES = 224


def depth_two_uint8_to_float(top: np.ndarray, bottom: np.ndarray) -> np.ndarray:
    """RHD depth encoding (reference data/dataset.py:1802-1807)."""
    return (top.astype(np.float32) * 256 + bottom.astype(np.float32)) / 65535.0


class RHD:
    name = "RHD"

    def __init__(self, base_path: str, split: str = "training",
                 queries: tuple = ("trans_images", "trans_Ks", "joints",
                                   "trans_joints2d", "trans_masks"),
                 train: bool | None = None, seed: int = 0):
        self.base_path = base_path
        self.split = "training" if split in ("training", "train") else "evaluation"
        self.queries = tuple(queries)
        self.train = train if train is not None else self.split == "training"
        self._rng = np.random.RandomState(seed)
        anno_path = os.path.join(base_path, self.split, f"anno_{self.split}.pickle")
        with open(anno_path, "rb") as f:
            self.annos = pickle.load(f)

    def __len__(self) -> int:
        return len(self.annos)

    def _img(self, kind: str, idx: int) -> np.ndarray:
        # uint8 until the crop warp, which runs through the native u8 path
        return _load_image(
            os.path.join(self.base_path, self.split, kind, "%05d.png" % idx),
            as_u8=True,
        )

    def get_sample(self, idx: int) -> dict:
        anno = self.annos[idx]
        K = np.asarray(anno["K"], np.float32)
        xyz = np.asarray(anno["xyz"], np.float32)  # (42, 3)
        uv_vis = np.asarray(anno["uv_vis"], np.float32)  # (42, 3) [u, v, vis]
        image = self._img("color", idx)
        mask_int = self._img("mask", idx)
        if mask_int.ndim == 3:
            mask_int = mask_int[..., 0]
        mask_r = mask_int > 17
        mask_l = (mask_int > 1) & (~mask_r)

        vis_l = uv_vis[:21, 2].sum()
        vis_r = uv_vis[21:, 2].sum()
        if vis_r < vis_l:
            side = 0
        elif vis_l < vis_r:
            side = 1
        else:
            side = 0 if mask_l.sum() > mask_r.sum() else 1

        if side == 1:  # right
            xyz21 = xyz[21:].copy()
            uv21 = uv_vis[21:, :2].copy()
            vis21 = uv_vis[21:, 2]
            mask_vis = mask_r.astype(np.uint8) * 255
        else:  # left: flip to right
            image = image[:, ::-1].copy()
            xyz21 = xyz[:21].copy()
            xyz21[:, 0] = -xyz21[:, 0]
            uv21 = uv_vis[:21, :2].copy()
            uv21[:, 0] = RAW_RES - uv21[:, 0]
            vis21 = uv_vis[:21, 2]
            mask_vis = mask_l[:, ::-1].astype(np.uint8) * 255

        joint_rel = xyz21 - xyz21[0]
        keypoint_scale = float(np.linalg.norm(joint_rel[12] - joint_rel[11]))

        # crop around joint 12
        crop_center = uv21[12].copy()
        crop_scale_noise = 1.0
        if self.train:
            crop_scale_noise = float(0.9 + 0.1 * self._rng.rand())
        uv_hw = uv21.copy()
        min_uv = np.maximum(uv_hw.min(0), 0.0)
        max_uv = np.minimum(uv_hw.max(0), RAW_RES)
        crop_size_best = float(
            np.clip(np.max(3 * np.maximum(max_uv - crop_center, crop_center - min_uv)),
                    50.0, 500.0)
        )
        scale = float(np.clip(OUT_RES / crop_size_best, 1.0, 10.0)) * crop_scale_noise
        css = OUT_RES / scale
        y1 = crop_center[1] - css // 2
        x1 = crop_center[0] - css // 2

        img_crop = crops.resized_crop(image, y1, x1, css, css,
                                      [OUT_RES, OUT_RES], out_u8=True)
        mask_crop = (
            crops.resized_crop(mask_vis, y1, x1, css, css, [OUT_RES, OUT_RES],
                               out_u8=True) > 0
        ).astype(np.uint8)

        uv21_crop = np.stack(
            [
                (uv21[:, 0] - crop_center[0]) * scale + OUT_RES // 2,
                (uv21[:, 1] - crop_center[1]) * scale + OUT_RES // 2,
            ],
            axis=1,
        ).astype(np.float32)
        scale_matrix = np.diag([scale, scale, 1.0]).astype(np.float32)
        trans_matrix = np.asarray(
            [
                [1, 0, -(crop_center[0] * scale - OUT_RES // 2)],
                [0, 1, -(crop_center[1] * scale - OUT_RES // 2)],
                [0, 0, 1],
            ],
            np.float32,
        )
        K_crop = trans_matrix @ scale_matrix @ K

        joints_frei = xyz21[RHD_TO_FREI]
        sample = {
            "imgs": img_crop,  # uint8; normalised on device
            "Ks": K_crop.astype(np.float32),
            "joints": joints_frei.astype(np.float32),
            "j2d_gt": uv21_crop[RHD_TO_FREI],
            "uv_vis": vis21[RHD_TO_FREI].astype(np.float32),
            "scales": np.float32(keypoint_scale),
            "segms_gt": mask_crop,
            "sides": np.int32(side),
            "root_xyz": joints_frei[9:10].astype(np.float32),
            "idxs": np.int64(idx),
        }
        return sample
