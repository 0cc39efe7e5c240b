"""Joint-order constants used by the MANO and NIMBLE layers,
`regress_joints_frei` and the real-data loaders (copied from
hifihr_tpu/geometry/joints.py).

FreiHAND order: 0 wrist; 1-4 thumb; 5-8 index; 9-12 middle; 13-16 ring;
17-20 pinky (base -> tip).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import constant

NUM_JOINTS = 21


def _perm_from_mapping(mapping: dict[int, int]) -> np.ndarray:
    """mapping {src_idx: dst_idx} -> gather indices p with out = in[p]."""
    p = np.zeros(NUM_JOINTS, dtype=np.int32)
    for src, dst in mapping.items():
        p[dst] = src
    return p


# legacy MANO joint order -> FreiHAND order (reference Mano2Frei)
_MANO2FREI = {0: 0,
              1: 5, 2: 6, 3: 7, 4: 8,
              5: 9, 6: 10, 7: 11, 8: 12,
              9: 17, 10: 18, 11: 19, 12: 20,
              13: 13, 14: 14, 15: 15, 16: 16,
              17: 1, 18: 2, 19: 3, 20: 4}
MANO_TO_FREI = _perm_from_mapping(_MANO2FREI)
# reference utils/fh_utils.py:558-571 (Mano2RHD)
_MANO2RHD = {0: 0,
             1: 8, 2: 7, 3: 6, 4: 5,
             5: 12, 6: 11, 7: 10, 8: 9,
             9: 20, 10: 19, 11: 18, 12: 17,
             13: 16, 14: 15, 15: 14, 16: 13,
             17: 4, 18: 3, 19: 2, 20: 1}
MANO_TO_RHD = _perm_from_mapping(_MANO2RHD)
RHD_TO_MANO = np.argsort(MANO_TO_RHD).astype(np.int32)
# reference utils/fh_utils.py:600-612 (RHD2Frei; {frei: rhd}): the RHD
# loader's remap to FreiHAND order
_FREI_FROM_RHD = {0: 0,
                  1: 4, 2: 3, 3: 2, 4: 1,
                  5: 8, 6: 7, 7: 6, 8: 5,
                  9: 12, 10: 11, 11: 10, 12: 9,
                  13: 16, 14: 15, 15: 14, 16: 13,
                  17: 20, 18: 19, 19: 18, 20: 17}
RHD_TO_FREI = np.array([_FREI_FROM_RHD[i] for i in range(NUM_JOINTS)], dtype=np.int32)


def remap(joints: torch.Tensor, perm) -> torch.Tensor:
    """Apply a joint permutation: (..., 21, D) -> (..., 21, D); the index
    list is copied to the device once."""
    return joints.index_select(-2, constant(perm, joints.device, torch.int64))

# reference utils/fh_utils.py:614-626 (HO3D2Frei; {frei: ho3d})
_FREI_FROM_HO3D = {0: 0,
                   1: 13, 2: 14, 3: 15, 4: 16,
                   5: 1, 6: 2, 7: 3, 8: 17,
                   9: 4, 10: 5, 11: 6, 12: 18,
                   13: 10, 14: 11, 15: 12, 16: 19,
                   17: 7, 18: 8, 19: 9, 20: 20}
HO3D_TO_FREI = np.array([_FREI_FROM_HO3D[i] for i in range(NUM_JOINTS)], dtype=np.int32)
# FreiHAND order -> HO3D order, for the HO3D submission file
FREI_TO_HO3D = np.argsort(HO3D_TO_FREI).astype(np.int32)

# MANO kinematic joints (16) regressed by J_regressor, placed in the 21-joint
# FreiHAND order; tips come from mesh vertices
REGRESSED16_TO_FREI = {0: 0,
                       1: 5, 2: 6, 3: 7,
                       4: 9, 5: 10, 6: 11,
                       7: 17, 8: 18, 9: 19,
                       10: 13, 11: 14, 12: 15,
                       13: 1, 14: 2, 15: 3}
# FreiHAND tip joint -> mesh vertex id
FREI_TIP_VERTEX = {4: 744, 8: 320, 12: 443, 16: 555, 20: 672}

# manopth ManoLayer 21-joint output order (wrist, thumb, index, middle, ring,
# pinky): kinematic transform index or tip slot per output joint
MANOPTH_REORDER = np.array(
    [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20],
    dtype=np.int32,
)
# tip vertices appended after the 16 kinematic joints, in slot order 16..20
MANOPTH_TIP_VERTS = np.array([745, 317, 444, 556, 673], dtype=np.int32)

# (parent, child) of the 20 FreiHAND bones, wrist outward per finger
FREI_BONES = np.array(
    [
        (0, 1), (1, 2), (2, 3), (3, 4),  # thumb
        (0, 5), (5, 6), (6, 7), (7, 8),  # index
        (0, 9), (9, 10), (10, 11), (11, 12),  # middle
        (0, 13), (13, 14), (14, 15), (15, 16),  # ring
        (0, 17), (17, 18), (18, 19), (19, 20),  # pinky
    ],
    dtype=np.int32,
)
