"""Synthetic hand dataset (counterpart of hifihr_tpu/data/synthetic.py):
self-consistent geometry from the port's MANO layer.

It stands in for FreiHAND where the data is not on disk (tests, the smoke
configs). The ground truth comes from the MANO layer, on the CPU, from the
same RandomState(seed) draws as the JAX package's, so a model trained on it
drives every loss branch (3D/2D joints, verts, silhouette, photometric with
texture_con). Images, masks and the other numpy fields are the JAX
package's arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from hifihr_tpu_torch.geometry.joints import NUM_JOINTS


class SyntheticHandDataset:
    name = "FreiHand"  # masquerades as FreiHand so loss branches engage

    def __init__(
        self,
        size: int = 256,
        image_size: int = 224,
        seed: int = 0,
        render_gt_sil: bool = False,
    ):
        from hifihr_tpu_torch.hand.mano import ManoLayer, regress_joints_frei

        self.size = size
        self.image_size = image_size
        rng = np.random.RandomState(seed)

        layer = ManoLayer(ncomps=45)
        pose = rng.randn(size, 48).astype(np.float32) * 0.3
        betas = rng.randn(size, 10).astype(np.float32) * 0.5
        with torch.no_grad():
            out = layer(torch.from_numpy(pose), torch.from_numpy(betas))
            joints = regress_joints_frei(out.verts, layer.J_regressor)
        self.verts = out.verts.numpy()
        self.joints = joints.numpy()
        self.pose = pose
        self.betas = betas
        self.faces = layer.faces_np

        s = image_size
        f = s * 1.8
        self.K = np.asarray([[f, 0, s / 2], [0, f, s / 2], [0, 0, 1]], np.float32)
        self.root_z = 0.4 + 0.2 * rng.rand(size).astype(np.float32)
        self.render_gt_sil = render_gt_sil

    def __len__(self) -> int:
        return self.size

    def get_sample(self, idx: int) -> dict:
        s = self.image_size
        root = np.asarray([0.0, 0.0, self.root_z[idx]], np.float32)
        joints_cam = self.joints[idx] + root
        uvw = joints_cam @ self.K.T
        j2d = uvw[:, :2] / uvw[:, 2:3]

        # cheap deterministic image: noise + bright blob at the hand
        r = np.random.RandomState(idx)
        img = r.rand(s, s, 3).astype(np.float32) * 0.2
        cx, cy = np.clip(j2d.mean(0).astype(int), 8, s - 8)
        img[max(cy - 16, 0) : cy + 16, max(cx - 16, 0) : cx + 16] += 0.5
        segm = np.zeros((s, s), np.float32)
        segm[max(cy - 16, 0) : cy + 16, max(cx - 16, 0) : cx + 16] = 1.0

        bone = np.linalg.norm(self.joints[idx][9] - self.joints[idx][10])
        return {
            "imgs": np.clip(img, 0, 1),
            "Ks": self.K,
            "joints": joints_cam.astype(np.float32),
            "verts": (self.verts[idx] + root).astype(np.float32),
            "j2d_gt": j2d.astype(np.float32),
            "open_2dj": (j2d + r.randn(NUM_JOINTS, 2) * 2).astype(np.float32),
            "open_2dj_con": (0.5 + 0.5 * r.rand(NUM_JOINTS, 1)).astype(np.float32),
            "texture_con": np.float32(1.0),
            "segms_gt": segm,
            "scales": np.float32(bone),
            "root_xyz": joints_cam[9:10].astype(np.float32),
            "mano_pose": self.pose[idx],
            "mano_shape": self.betas[idx],
        }
