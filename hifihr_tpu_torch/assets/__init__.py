"""MANO model asset (a copy of hifihr_tpu/assets/mano_right.npz)."""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np

DEFAULT_MANO_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mano_right.npz")


class ManoModel(NamedTuple):
    v_template: np.ndarray  # (778, 3) rest-pose vertices
    shapedirs: np.ndarray  # (778, 3, 10) shape blendshapes
    posedirs: np.ndarray  # (778, 3, 135) pose-corrective blendshapes
    J_regressor: np.ndarray  # (16, 778) joint regressor
    lbs_weights: np.ndarray  # (778, 16) skinning weights
    hands_components: np.ndarray  # (45, 45) pose PCA basis
    hands_mean: np.ndarray  # (45,) mean pose (axis-angle, 15 joints)
    faces: np.ndarray  # (1538, 3) int32 triangle indices
    parents: np.ndarray  # (16,) int32 kinematic parents, parents[0] == -1


@functools.lru_cache(maxsize=4)
def load_mano_model(path: str | None = None) -> ManoModel:
    with np.load(path or DEFAULT_MANO_NPZ) as z:
        return ManoModel(**{k: z[k] for k in ManoModel._fields})
