"""Stacked-hourglass heatmap network (counterpart of
hifihr_tpu/networks/hourglass.py, the reference's legacy Net_HM_HG,
network/net_hg.py), NCHW inside.

A 7x7 / stride-2 stem to stride 4, then `num_stacks` hourglass modules, each
emitting `num_joints` heatmaps with intermediate supervision, and the
soft-argmax uv decoding that the hm_integral losses read
(utils/visualize_util.py:826-880 compute_uv_from_integral). Module names
follow the flax parameter paths (stem_conv, hg0.up_4.bn1, post_res0, ...),
so hifihr_tpu_torch.convert maps them one to one; the stem is the JAX
package's StemConvS2D(64, 7, pad_lo=3, use_bias=True), here a StemConv
with a bias. Every BatchNorm is flax's default: momentum 0.99, eps 1e-5.

Two details of the JAX code that the port keeps:
  * the hourglass depth is clamped so the innermost max pool never reaches
    0 px; the JAX code reads it from the traced shape, the port from the
    image size it is built for (224^2: 56 px at the hourglass, depth 4);
  * the upsampling is jax.image.resize(..., "nearest"), which samples at
    half-pixel centres: F.interpolate's "nearest-exact". The two differ
    where a level is odd (224^2: 56 -> 28 -> 14 -> 7 -> 3 is resized back
    to 7), where "nearest" would read other rows.
The branch runs on the raw images in fp32, outside the encoder's autocast,
as the JAX package builds it without a dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
from torch import nn

from hifihr_tpu_torch.networks.batchnorm import BatchNorm2d
from hifihr_tpu_torch.networks.resnet import StemConv

BN_MOMENTUM = 0.99  # flax.linen.BatchNorm's default


def _norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, BN_MOMENTUM)


class HGResidual(nn.Module):
    """Pre-activation bottleneck: BN-ReLU-1x1, BN-ReLU-3x3, BN-ReLU-1x1, with
    a 1x1 projection of the skip where the width changes."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        half = features // 2
        self.bn1, self.conv1 = _norm(cin), nn.Conv2d(cin, half, 1)
        self.bn2, self.conv2 = _norm(half), nn.Conv2d(half, half, 3, padding=1)
        self.bn3, self.conv3 = _norm(half), nn.Conv2d(half, features, 1)
        if cin != features:
            self.skip = nn.Conv2d(cin, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(Fn.relu(self.bn1(x)))
        y = self.conv2(Fn.relu(self.bn2(y)))
        y = self.conv3(Fn.relu(self.bn3(y)))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + y


def hourglass_depth(size: int, depth: int = 4) -> int:
    """The JAX Hourglass's clamp: min(depth, max(1, floor(log2(size))))."""
    return min(depth, max(1, int(math.log2(size))))


class Hourglass(nn.Module):
    """One hourglass over a `size` x `size` map (the depth is clamped for
    it, as the JAX module clamps it for its input)."""

    def __init__(self, features: int, size: int, depth: int = 4):
        super().__init__()
        self.depth = hourglass_depth(size, depth)
        for level in range(self.depth, 0, -1):
            setattr(self, f"up_{level}", HGResidual(features, features))
            setattr(self, f"low1_{level}", HGResidual(features, features))
            setattr(self, f"low3_{level}", HGResidual(features, features))
        self.low2_1 = HGResidual(features, features)

    def _level(self, level: int, x: torch.Tensor) -> torch.Tensor:
        up1 = getattr(self, f"up_{level}")(x)
        low = getattr(self, f"low1_{level}")(Fn.max_pool2d(x, 2, 2))
        low = self._level(level - 1, low) if level > 1 else self.low2_1(low)
        low = getattr(self, f"low3_{level}")(low)
        return up1 + Fn.interpolate(low, size=up1.shape[-2:], mode="nearest-exact")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class NetHMHG(nn.Module):
    """images (B, S, S, cin) in [0, 1] -> a list of `num_stacks` heatmaps
    (B, S/4, S/4, num_joints), NHWC as the JAX package returns them; `cin`
    is 4 with the `four_channel` input."""

    def __init__(self, image_size: int = 224, num_stacks: int = 2, features: int = 256, num_joints: int = 21,
                 cin: int = 3):
        super().__init__()
        self.num_stacks = num_stacks
        self.stem_conv = StemConv(64, 7, 3, bias=True, cin=cin)
        self.stem_bn = _norm(64)
        self.stem_res1 = HGResidual(64, 128)
        self.stem_res2 = HGResidual(128, 128)
        self.stem_res3 = HGResidual(128, features)
        size = image_size // 2 // 2  # the stem's stride 2, then the 2x2 pool (floors)
        for s in range(num_stacks):
            setattr(self, f"hg{s}", Hourglass(features, size))
            setattr(self, f"post_res{s}", HGResidual(features, features))
            setattr(self, f"post_conv{s}", nn.Conv2d(features, features, 1))
            setattr(self, f"post_bn{s}", _norm(features))
            setattr(self, f"hm{s}", nn.Conv2d(features, num_joints, 1))
            if s < num_stacks - 1:
                setattr(self, f"merge_feat{s}", nn.Conv2d(features, features, 1))
                setattr(self, f"merge_hm{s}", nn.Conv2d(num_joints, features, 1))

    def forward(self, images: torch.Tensor) -> list:
        x = Fn.relu(self.stem_bn(self.stem_conv(images.permute(0, 3, 1, 2))))
        x = self.stem_res1(x)
        x = Fn.max_pool2d(x, 2, 2)
        x = self.stem_res3(self.stem_res2(x))
        outs = []
        for s in range(self.num_stacks):
            y = getattr(self, f"post_res{s}")(getattr(self, f"hg{s}")(x))
            y = Fn.relu(getattr(self, f"post_bn{s}")(getattr(self, f"post_conv{s}")(y)))
            hm = getattr(self, f"hm{s}")(y)
            outs.append(hm.permute(0, 2, 3, 1))
            if s < self.num_stacks - 1:
                x = x + getattr(self, f"merge_feat{s}")(y) + getattr(self, f"merge_hm{s}")(hm)
        return outs


def heatmaps_to_uv(hm: torch.Tensor) -> torch.Tensor:
    """Soft-argmax (integral) decoding: (B, H, W, J) -> (B, J, 2) uv in
    heatmap pixels, each pixel at its centre (reference
    compute_uv_from_integral)."""
    b, h, w, j = hm.shape
    prob = torch.softmax(hm.reshape(b, h * w, j), dim=1).reshape(b, h, w, j)
    xs = torch.arange(w, dtype=hm.dtype, device=hm.device) + 0.5
    ys = torch.arange(h, dtype=hm.dtype, device=hm.device) + 0.5
    u = torch.einsum("bhwj,w->bj", prob, xs)
    v = torch.einsum("bhwj,h->bj", prob, ys)
    return torch.stack([u, v], dim=-1)
