"""Assets: MANO and NIMBLE, read by path with numpy from the asset files in
the checkout (hifihr_tpu_torch/assets/*.npz, raw data both sides read),
and the path of the perceptual loss's VGG19 features."""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                          "hifihr_tpu_torch", "assets")
DEFAULT_MANO_NPZ = os.path.join(_ASSET_DIR, "mano_right.npz")
# a converted licensed NIMBLE release (assets/nimble.npz, the same schema)
# takes precedence over the MANO-derived placeholder, as in the JAX package
DEFAULT_NIMBLE_NPZ = os.path.join(_ASSET_DIR, "nimble.npz")
if not os.path.exists(DEFAULT_NIMBLE_NPZ):
    DEFAULT_NIMBLE_NPZ = os.path.join(_ASSET_DIR, "nimble_placeholder.npz")


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


class NimbleModel(NamedTuple):
    """The NIMBLE asset schema of hifihr_tpu/hand/nimble.py::NimbleModel."""

    v_template: np.ndarray  # (5990, 3)
    faces: np.ndarray  # (11926, 3) int32
    shapedirs: np.ndarray  # (5990, 3, 20)
    J_regressor: np.ndarray  # (25, 5990)
    lbs_weights: np.ndarray  # (5990, 25); the first 16 columns skin
    pose_basis: np.ndarray  # (30, 45) pose PCA over the 15 finger joints
    hands_mean: np.ndarray  # (45,)
    tex_mean: np.ndarray  # (5990, 3) per-vertex albedo
    tex_basis: np.ndarray  # (5990, 3, 10)
    mano_vertex_map: np.ndarray  # (778,) int32
    parents: np.ndarray  # (16,) int32
    posedirs: np.ndarray | None = None  # (5990, 3, 135) pose correctives
    vert_uv: np.ndarray | None = None  # (V, 2) in [0, 1]
    tex_mean_uv: np.ndarray | None = None  # (h, w, 3) diffuse mean map
    tex_basis_uv: np.ndarray | None = None  # (h, w, 3, T)
    face_uv: np.ndarray | None = None  # (F, 3, 2) per-corner seamed atlas
    normal_mean_uv: np.ndarray | None = None  # (h, w, 3) tangent space, [0, 1]
    normal_basis_uv: np.ndarray | None = None  # (h, w, 3, T)
    spec_mean_uv: np.ndarray | None = None  # (h, w, 1)
    spec_basis_uv: np.ndarray | None = None  # (h, w, 1, T)


@functools.lru_cache(maxsize=2)
def load_nimble_model(path: str | None = None) -> NimbleModel:
    with np.load(path or DEFAULT_NIMBLE_NPZ) as z:
        return NimbleModel(**{k: z[k] for k in NimbleModel._fields if k in z.files})

# the perceptual loss's VGG19 features through relu3_2, in the JAX package's
# npz layout (conv{i}_kernel HWIO, conv{i}_bias; tools/convert_torch_weights.py
# vgg). When absent, the loss runs on seeded random features
# (benchmark.reference.losses.perceptual.load_or_init_vgg)
VGG_NPZ = os.path.join(_ASSET_DIR, "vgg19_features.npz")
