"""LPIPS perceptual metric, AlexNet backbone (counterpart of
hifihr_tpu/losses/lpips.py, the `lpips` package the reference uses for
texture evaluation: train_hrnet.py:13, 563, 158).

AlexNet conv features at 5 taps, unit-normalised over channels, squared
difference, 1x1 linear heads, spatial mean, summed over taps. Inputs are
NHWC RGB in [-1, 1]. Weights are the JAX package's npz layout
(`conv{i}_kernel` HWIO, `conv{i}_bias`, `lin{i}_kernel` (1, 1, C, 1);
tools/convert_torch_weights.py lpips writes it). Without the file the
features are seeded random ones with flax's initialisers (lecun_normal,
truncated, zero biases), flagged by `pretrained` = False.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from hifihr_tpu_torch import constant, variance_scaling_
from hifihr_tpu_torch.utils.weights import asset_path

LPIPS_NPZ = asset_path("lpips_alex.npz")

# AlexNet conv stack: (out_ch, kernel, stride, padding)
_ALEX = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """lpips(img0, img1) -> (B,) distances; images (B, H, W, 3) in [-1, 1],
    H and W at least 64 (the stride-4 conv and two 3x3 / 2 pools)."""

    def __init__(self, npz_path: str | None = LPIPS_NPZ, seed: int = 0):
        super().__init__()
        cin = 3
        self.convs = nn.ModuleList()
        for ch, k, s, p in _ALEX:
            self.convs.append(nn.Conv2d(cin, ch, k, s, p))
            cin = ch
        self.lins = nn.ModuleList(nn.Conv2d(ch, 1, 1, bias=False) for ch, *_ in _ALEX)
        self.requires_grad_(False)
        self.pretrained = bool(npz_path) and os.path.exists(npz_path)
        with torch.no_grad():
            if self.pretrained:
                with np.load(npz_path) as z:
                    for i, conv in enumerate(self.convs):
                        conv.weight.copy_(torch.from_numpy(z[f"conv{i}_kernel"].transpose(3, 2, 0, 1).copy()))
                        conv.bias.copy_(torch.from_numpy(z[f"conv{i}_bias"]))
                    for i, lin in enumerate(self.lins):
                        lin.weight.copy_(torch.from_numpy(z[f"lin{i}_kernel"].transpose(3, 2, 0, 1).copy()))
            else:
                gen = torch.Generator().manual_seed(seed)
                for m in list(self.convs) + list(self.lins):
                    variance_scaling_(m.weight, 1.0, m.weight[0].numel(), gen)
                    if m.bias is not None:
                        m.bias.zero_()

    def _features(self, x: torch.Tensor) -> list:
        shift = constant(_SHIFT, x.device, x.dtype)
        scale = constant(_SCALE, x.device, x.dtype)
        x = ((x - shift) / scale).permute(0, 3, 1, 2)
        taps = []
        for i, conv in enumerate(self.convs):
            x = Fn.relu(conv(x))
            taps.append(x)
            if i in (0, 1):
                x = Fn.max_pool2d(x, 3, 2)
        return taps

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for lin, a, b in zip(self.lins, self._features(img0), self._features(img1)):
            d = (a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
                 - b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)) ** 2
            total = total + lin(d).mean(dim=(1, 2, 3))
        return total
