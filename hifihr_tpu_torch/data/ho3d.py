"""HO-3D v2 loader (counterpart of hifihr_tpu/data/ho3d.py: the same
samples, byte for byte).

Mirrors the reference's data/dataset.py HO3D branch (:1023-1215) + HO3D class
(:1928-2057) + data_dic normalisation (traineval_util.py:157-205):
  * sequences from train.txt / evaluation.txt; per-frame meta pkl with
    camMat, handPose/Beta/Trans, handJoints3D, objCorners3D,
    handBoundingBox (evaluation only)
  * cam_extr = diag(1, -1, -1) merged into K (:1940, :1062)
  * crop box from hand (+optionally object) 2D extent, 4x scale, ±10 px
    margin, clamped [50, 640]; train-time noise: center ±5 px gaussian,
    scale in [0.9, 1.0]
  * K_crop = T @ S @ K; final examples get K and joints flipped by
    [1, -1, -1] (traineval_util.py:115-146) — applied here
  * joints remapped HO3D -> FreiHAND order.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from hifihr_tpu_torch.data.freihand import _load_image
from hifihr_tpu_torch.geometry import crops
from hifihr_tpu_torch.geometry.joints import HO3D_TO_FREI

OUT_RES = 224
CAM_EXTR = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
FLIP_YZ = np.asarray([1.0, -1.0, -1.0], np.float32)


class HO3D:
    name = "HO3D"

    def __init__(self, base_path: str, split: str = "training",
                 queries: tuple = ("trans_images", "trans_Ks", "joints",
                                   "trans_joints2d", "trans_masks"),
                 train: bool | None = None, seed: int = 0):
        self.base_path = base_path
        self.split = "train" if split in ("training", "train") else "evaluation"
        self.queries = tuple(queries)
        self.train = train if train is not None else self.split == "train"
        self._rng = np.random.RandomState(seed)

        list_file = os.path.join(
            base_path, ("train.txt" if self.split == "train" else "evaluation.txt")
        )
        with open(list_file) as f:
            self.frames = [line.strip() for line in f if line.strip()]
        self.seq_dir = os.path.join(
            base_path, "train" if self.split == "train" else "evaluation"
        )
        # openpose pseudo-labels: base_path/openpose/<seq>/detect.json holding
        # [coords_per_frame, confs_per_frame] (dataset.py:1960-1964, 2046-2057)
        self._open2dj_cache: dict[str, list | None] = {}

    def __len__(self) -> int:
        return len(self.frames)

    def _open_2dj(self, seq: str, frame_idx: int):
        if seq not in self._open2dj_cache:
            import json

            path = os.path.join(self.base_path, "openpose", seq, "detect.json")
            self._open2dj_cache[seq] = (
                json.load(open(path)) if os.path.exists(path) else None
            )
        det = self._open2dj_cache[seq]
        if det is None:
            return None, None
        j, con = det[0][frame_idx], det[1][frame_idx]
        return (
            np.asarray(j, np.float32).reshape(21, -1)[:, :2],
            np.asarray(con, np.float32).reshape(21, 1),
        )

    def get_sample(self, idx: int) -> dict:
        seq, fid = self.frames[idx].split("/")
        img_path = os.path.join(self.seq_dir, seq, "rgb", f"{fid}.png")
        if not os.path.exists(img_path):
            img_path = os.path.join(self.seq_dir, seq, "rgb", f"{fid}.jpg")
        image = _load_image(img_path, as_u8=True)  # (480, 640, 3) u8
        with open(os.path.join(self.seq_dir, seq, "meta", f"{fid}.pkl"), "rb") as f:
            meta = pickle.load(f)

        K = np.asarray(meta["camMat"], np.float32) @ CAM_EXTR
        j3d = np.asarray(meta["handJoints3D"], np.float32)
        eval_mode = meta.get("handBoundingBox") is not None and (
            "handBoundingBox" in meta and self.split == "evaluation"
        )
        sample: dict = {"idxs": np.int64(idx)}

        if eval_mode:
            bb = meta["handBoundingBox"]
            uv21 = np.asarray([[bb[0], bb[1]], [bb[2], bb[3]]], np.float32)
            root = j3d.reshape(-1)[:3].copy()  # eval set: only the wrist joint
            root[1:] = -root[1:]
            sample["root_xyz"] = root[None]
        else:
            j3d = j3d.reshape(21, 3)
            uvw = j3d @ K.T
            uv21 = uvw[:, :2] / uvw[:, 2:3]
            joints = j3d[HO3D_TO_FREI] * FLIP_YZ
            sample["joints"] = joints.astype(np.float32)
            sample["root_xyz"] = joints[9:10].astype(np.float32)
            if "manos" in self.queries:
                sample["hand_pose"] = np.asarray(meta["handPose"], np.float32)
                sample["hand_shape"] = np.asarray(meta["handBeta"], np.float32)

        open_2dj, open_con = self._open_2dj(seq, int(fid))

        # crop box (4x extent, +-10 margin, clamp [50, 640])
        crop_center = (uv21.max(0) + uv21.min(0)) / 2
        if self.train:
            crop_center = crop_center + 5 * self._rng.randn(2)
        crop_scale_noise = float(0.9 + 0.1 * self._rng.rand()) if self.train else 1.0
        min_uv = np.maximum(uv21.min(0), 0.0) - 10.0
        max_uv = np.minimum(uv21.max(0), np.asarray([640.0, 480.0])) + 10.0
        crop_size_best = float(
            np.clip(np.max(4 * np.maximum(max_uv - crop_center, crop_center - min_uv)),
                    50.0, 640.0)
        )
        scale = min(OUT_RES / crop_size_best, 10.0) * crop_scale_noise
        css = OUT_RES / scale
        y1 = crop_center[1] - css // 2
        x1 = crop_center[0] - css // 2

        img_crop = crops.resized_crop(image, y1, x1, css, css,
                                      [OUT_RES, OUT_RES], out_u8=True)
        sample["imgs"] = img_crop  # uint8; normalised on device

        mask_path = os.path.join(self.seq_dir, seq, "seg", f"{fid}.png")
        if os.path.exists(mask_path) and "trans_masks" in self.queries:
            mask = _load_image(mask_path, as_u8=True)
            hand_mask = mask[..., 0] if mask.ndim == 3 else mask
            hand_mask = (hand_mask >= 128).astype(np.uint8) * 255
            sample["segms_gt"] = (
                crops.resized_crop(hand_mask, y1, x1, css, css,
                                   [OUT_RES, OUT_RES], out_u8=True) >= 128
            ).astype(np.uint8)

        def to_crop(uv):
            return np.stack(
                [
                    (uv[:, 0] - crop_center[0]) * scale + OUT_RES // 2,
                    (uv[:, 1] - crop_center[1]) * scale + OUT_RES // 2,
                ],
                axis=1,
            ).astype(np.float32)

        if not eval_mode:
            sample["j2d_gt"] = to_crop(uv21)[HO3D_TO_FREI]
        if open_2dj is not None:
            sample["open_2dj"] = to_crop(open_2dj)
            sample["open_2dj_con"] = open_con
            sample["texture_con"] = np.float32(open_con.mean())

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
        # sign flip merged into the final K (traineval_util.py:115-117)
        sample["Ks"] = (K_crop * FLIP_YZ[None, :]).astype(np.float32)
        return sample
