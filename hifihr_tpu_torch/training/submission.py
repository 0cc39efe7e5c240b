"""Prediction dumps in the official FreiHAND / HO-3D submission formats
(counterpart of hifihr_tpu/training/submission.py).

Reference: utils/train_utils.py:242-254 (`dump` writes pred.json as
[xyz_list, verts_list]) and train_hrnet.py:119-136, 284-293 (HO3D joints are
remapped Frei->HO3D and y/z-flipped before dumping).
"""

from __future__ import annotations

import json
import os

import numpy as np

from hifihr_tpu_torch.geometry.joints import FREI_TO_HO3D

_FLIP_YZ = np.asarray([1.0, -1.0, -1.0], np.float32)


def to_ho3d_convention(joints_frei: np.ndarray) -> np.ndarray:
    """(N, 21, 3) FreiHAND-order joints -> HO3D order with y/z negated."""
    return joints_frei[:, FREI_TO_HO3D] * _FLIP_YZ


def dump_predictions(path: str, xyz_list, verts_list, dat_name: str = "FreiHand"):
    """Write pred.json for the online evaluation servers."""
    xyz = np.asarray(xyz_list, np.float64)
    verts = np.asarray(verts_list, np.float64)
    if dat_name == "HO3D":
        xyz = to_ho3d_convention(xyz.astype(np.float32)).astype(np.float64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump([xyz.tolist(), verts.tolist()], f)
    print(f"Dumped {len(xyz)} joints and {len(verts)} verts predictions to {path}")
    return path
