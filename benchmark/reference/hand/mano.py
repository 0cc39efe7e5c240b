"""MANO parametric hand layer (counterpart of hifihr_tpu/hand/mano.py).

PCA pose coefficients -> axis-angle -> rotation matrices, shape and pose
blendshapes, a 3-level batched kinematic chain, linear blend skinning,
fingertip assembly, joint reorder and root-centering, in fp32. Also
`regress_joints_frei`, the J_regressor + fingertip-vertex joints that the
model uses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from benchmark.reference import constant
from benchmark.reference.assets import ManoModel, load_mano_model
from benchmark.reference.geometry.joints import (
    FREI_TIP_VERTEX,
    MANOPTH_REORDER,
    MANOPTH_TIP_VERTS,
    REGRESSED16_TO_FREI,
)
from benchmark.reference.geometry.rotations import axis_angle_to_matrix

# finger chains run root -> lev1 -> lev2 -> lev3
# (kintree parents [-1,0,1,2,0,4,5,0,7,8,0,10,11,0,13,14])
_LEV1 = [1, 4, 7, 10, 13]
_LEV2 = [2, 5, 8, 11, 14]
_LEV3 = [3, 6, 9, 12, 15]
# concat order [root, lev1, lev2, lev3] -> kinematic joint order
_LEVELS_TO_KINEMATIC = [0, 1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 5, 10, 15]

# source row in the concat [joints16; tip_verts5] of each FreiHAND joint
_FREI_GATHER = np.zeros(21, dtype=np.int64)
for _src, _dst in REGRESSED16_TO_FREI.items():
    _FREI_GATHER[_dst] = _src
for _i, _tip in enumerate(sorted(FREI_TIP_VERTEX)):
    _FREI_GATHER[_tip] = 16 + _i
_FREI_TIP_VERTS = np.array([FREI_TIP_VERTEX[k] for k in sorted(FREI_TIP_VERTEX)])


class ManoOutput(NamedTuple):
    verts: torch.Tensor  # (B, 778, 3)
    joints: torch.Tensor  # (B, 21, 3) FreiHAND order
    full_pose: torch.Tensor  # (B, 16, 3) axis-angle incl. global rot


def _rigid_tf(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """rot (..., 3, 3), t (..., 3) -> homogeneous (..., 4, 4)."""
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = constant([0.0, 0.0, 0.0, 1.0], rot.device, rot.dtype).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _take(x: torch.Tensor, index, dim: int = 1) -> torch.Tensor:
    """x indexed along `dim` by a constant index list, cached on x's device."""
    return x.index_select(dim, constant(index, x.device, torch.int64))


class ManoLayer(nn.Module):
    """MANO with center_idx=9, flat_hand_mean=False and PCA pose (ncomps
    coefficients after the 3 global-rotation entries). The model tensors are
    non-persistent buffers: they follow `.to(device)` and stay out of the
    state dict."""

    def __init__(self, model: ManoModel | None = None, ncomps: int = 45,
                 center_idx: int | None = 9):
        super().__init__()
        m = model or load_mano_model()
        self.ncomps = min(ncomps, 45)
        self.center_idx = center_idx
        self.v_template_np = np.asarray(m.v_template, np.float32)
        self.faces_np = np.asarray(m.faces, np.int32)

        def buf(name, a, dtype=torch.float32):
            self.register_buffer(name, torch.as_tensor(np.asarray(a), dtype=dtype),
                                 persistent=False)

        buf("v_template", m.v_template)
        buf("shapedirs", m.shapedirs)
        buf("posedirs", np.asarray(m.posedirs).reshape(778 * 3, 135))
        buf("J_regressor", m.J_regressor)
        buf("lbs_weights", m.lbs_weights)
        buf("hands_components", np.asarray(m.hands_components)[: self.ncomps])
        buf("hands_mean", m.hands_mean)
        buf("faces", m.faces, torch.int64)

    def full_pose_from_coeffs(self, pose_coeffs: torch.Tensor) -> torch.Tensor:
        """(B, 3 + ncomps) -> (B, 16, 3) axis-angle including global rot."""
        b = pose_coeffs.shape[0]
        root = pose_coeffs[:, :3]
        hand = pose_coeffs[:, 3:3 + self.ncomps] @ self.hands_components
        hand = self.hands_mean[None] + hand
        return torch.cat([root, hand], dim=1).reshape(b, 16, 3)

    def forward(self, pose_coeffs: torch.Tensor, betas: torch.Tensor) -> ManoOutput:
        """pose_coeffs (B, 3 + ncomps) [global rot | PCA coeffs]; betas (B, 10)."""
        b = pose_coeffs.shape[0]
        full_pose = self.full_pose_from_coeffs(pose_coeffs)
        rots = axis_angle_to_matrix(full_pose)  # (B, 16, 3, 3)

        v_shaped = self.v_template[None] + torch.einsum("vds,bs->bvd", self.shapedirs, betas)
        joints16 = torch.einsum("jv,bvd->bjd", self.J_regressor, v_shaped)
        eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
        pose_map = (rots[:, 1:] - eye).reshape(b, 135)
        v_posed = v_shaped + (pose_map @ self.posedirs.T).reshape(b, 778, 3)

        j1, j2, j3 = (_take(joints16, lev) for lev in (_LEV1, _LEV2, _LEV3))
        root_tf = _rigid_tf(rots[:, 0], joints16[:, 0])  # (B, 4, 4)
        lev1_tf = root_tf[:, None] @ _rigid_tf(_take(rots, _LEV1), j1 - joints16[:, 0:1])
        lev2_tf = lev1_tf @ _rigid_tf(_take(rots, _LEV2), j2 - j1)
        lev3_tf = lev2_tf @ _rigid_tf(_take(rots, _LEV3), j3 - j2)
        tfs = _take(torch.cat([root_tf[:, None], lev1_tf, lev2_tf, lev3_tf], dim=1), _LEVELS_TO_KINEMATIC)

        # remove the rest-pose joint location (inverse-bind translation)
        posed_j = torch.einsum("bjxy,bjy->bjx", tfs[:, :, :3, :3], joints16)
        rel_tfs = tfs.clone()
        rel_tfs[:, :, :3, 3] -= posed_j

        T = torch.einsum("vj,bjxy->bvxy", self.lbs_weights, rel_tfs)  # (B, 778, 4, 4)
        verts = torch.einsum("bvxy,bvy->bvx", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]

        jtr16 = tfs[:, :, :3, 3]
        tips = _take(verts, MANOPTH_TIP_VERTS)
        jtr = _take(torch.cat([jtr16, tips], dim=1), MANOPTH_REORDER)
        if self.center_idx is not None:
            center = jtr[:, self.center_idx:self.center_idx + 1]
            jtr = jtr - center
            verts = verts - center
        return ManoOutput(verts=verts, joints=jtr, full_pose=full_pose)


def regress_joints_frei(verts: torch.Tensor, J_regressor: torch.Tensor) -> torch.Tensor:
    """FreiHAND-order 21 joints from a posed MANO mesh: verts (B, 778, 3),
    J_regressor (16, 778) -> (B, 21, 3)."""
    joints16 = torch.einsum("jv,bvd->bjd", J_regressor, verts)
    tips = _take(verts, _FREI_TIP_VERTS)
    return _take(torch.cat([joints16, tips], dim=1), _FREI_GATHER)
