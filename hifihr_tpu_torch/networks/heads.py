"""Regression heads (counterpart of
hifihr_tpu/networks/heads.py): MMPool, HandEncoder, LightEstimator. Module
names follow the flax parameter names."""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch import nn

from hifihr_tpu_torch.networks.batchnorm import BatchNorm1d


class MMPool(nn.Module):
    """Global pool: sigmoid(p) * max + (1 - sigmoid(p)) * avg over H, W."""

    def __init__(self):
        super().__init__()
        self.p = nn.Parameter(torch.zeros(1))

    def forward(self, x):  # (B, C, H, W) -> (B, C)
        w = torch.sigmoid(self.p.to(x.dtype))
        return x.amax(dim=(2, 3)) * w + x.mean(dim=(2, 3)) * (1.0 - w)


class HandEncoder(nn.Module):
    """features (B, in_dim) -> MANO parameter dict (pose, shape, scale,
    trans, rot)."""

    def __init__(self, in_dim: int, shape_ncomp: int = 10, pose_ncomp: int = 48,
                 use_mean_shape: bool = False):
        super().__init__()
        self.shape_ncomp = shape_ncomp
        self.use_mean_shape = use_mean_shape
        self.base_fc0 = nn.Linear(in_dim, 1024)
        self.base_bn0 = BatchNorm1d(1024)
        self.base_fc1 = nn.Linear(1024, 512)
        self.base_bn1 = BatchNorm1d(512)
        self.heads = {"pose": ((128,), pose_ncomp), "scale": ((128, 32), 1),
                      "trans": ((128, 32), 3), "rot": ((128, 32), 3)}
        if not use_mean_shape:
            self.heads["shape"] = ((128,), shape_ncomp)
        for name, (hidden, out) in self.heads.items():
            cin = 512
            for i, h in enumerate(hidden):
                self.add_module(f"{name}_fc{i}", nn.Linear(cin, h))
                cin = h
            self.add_module(f"{name}_out", nn.Linear(cin, out))

    def _head(self, name, x):
        hidden, _ = self.heads[name]
        for i in range(len(hidden)):
            x = Fn.relu(getattr(self, f"{name}_fc{i}")(x))
        return getattr(self, f"{name}_out")(x)

    def forward(self, features):
        x = Fn.relu(self.base_bn0(self.base_fc0(features)))
        base = Fn.relu(self.base_bn1(self.base_fc1(x)))
        if self.use_mean_shape:
            shape = base.new_zeros((base.shape[0], self.shape_ncomp))
        else:
            shape = self._head("shape", base)
        return {
            "pose_params": self._head("pose", base),
            "shape_params": shape,
            "texture_params": None,
            "scale": self._head("scale", base),
            "trans": self._head("trans", base),
            "rot": self._head("rot", base),
        }


class LightEstimator(nn.Module):
    """low features (B, C, 28, 28) -> {'colors': (B, 3) in [-1, 1],
    'directions': (B, 3)}."""

    def __init__(self, cin: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 48, 1, 2)
        self.conv2 = nn.Conv2d(48, 48, 3)  # VALID
        self.conv3 = nn.Conv2d(48, 64, 3, 2)  # VALID
        self.fc0 = nn.Linear(256, 64)
        self.fc1 = nn.Linear(64, 6)

    def forward(self, low):
        x = Fn.relu(self.conv1(low))  # (B, 48, 14, 14)
        x = Fn.relu(self.conv2(x))  # (B, 48, 12, 12)
        x = Fn.max_pool2d(x, 3, 1, 1)
        x = Fn.relu(self.conv3(x))  # (B, 64, 5, 5)
        x = Fn.max_pool2d(x, 2, 2)  # (B, 64, 2, 2)
        # flatten in NHWC order, as the flax module does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = Fn.relu(self.fc0(x))
        lights = self.fc1(x)
        return {"colors": lights[:, :3].clamp(-1.0, 1.0), "directions": lights[:, 3:]}
