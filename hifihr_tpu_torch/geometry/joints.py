"""Joint-order constants used by the MANO layer and `regress_joints_frei`
(copied from hifihr_tpu/geometry/joints.py).

FreiHAND order: 0 wrist; 1-4 thumb; 5-8 index; 9-12 middle; 13-16 ring;
17-20 pinky (base -> tip).
"""

from __future__ import annotations

import numpy as np

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
