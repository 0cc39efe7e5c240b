"""ResNet-18/50/101 image encoders (counterpart of
hifihr_tpu/networks/resnet.py), NCHW inside.

torchvision ResNet v1 with the reference's layer4 stride of 1, so the final
map stays 14x14 at 224^2. Returns (low, pooled): the layer2 map (28x28x512
for res50) and the MMPool-pooled layer4 features. The stem is `StemConv`,
the plain stride-2 conv that the JAX package's space-to-depth stem stands
for; `hifihr_tpu_torch.convert` undoes that layout. Module names follow the flax
parameter paths (layer{stage}_{i}, downsample_conv, ...), so the converter
maps names one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch import nn

from hifihr_tpu_torch import constant
from hifihr_tpu_torch.networks.batchnorm import BatchNorm2d
from hifihr_tpu_torch.networks.heads import MMPool

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    """NHWC float images in [0, 1] -> imagenet-normalised (3 channels)."""
    mean = constant(IMAGENET_MEAN, images.device, images.dtype)
    std = constant(IMAGENET_STD, images.device, images.dtype)
    return (images - mean) / std


def _conv(cin, cout, k, stride=1, pad=0):
    return nn.Conv2d(cin, cout, k, stride, pad, bias=False)


class StemConv(nn.Conv2d):
    """8x8 / stride-2 conv with zero padding (4, 2): what the JAX package's
    StemConvS2D computes (4x4 taps over 2x2 patches, s2d padding (2, 1)),
    every one of its 64 taps per channel included. A torchvision 7x7 /
    pad-3 kernel is this kernel's taps [1:, 1:].

    The weight is stored 8x8; forward computes the same sums in s2d form,
    a stride-1 4x4 conv over 12 channels, which cuDNN runs faster than the
    3-channel stride-2 8x8 conv (`chip_smoke.py --profile`, PERF.md)."""

    def __init__(self):
        super().__init__(3, 64, 8, 2, 0, bias=False)

    def forward(self, x):
        b, c, h, w = x.shape
        # (b, h, w, c) -> (b, h/2, w/2, (di, dj, c)), the order of StemConvS2D
        xs = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c).transpose(2, 3)
        xs = xs.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)  # channels-last NCHW
        o = self.weight.shape[0]
        ws = self.weight.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)
        return Fn.conv2d(Fn.pad(xs, (2, 1, 2, 1)), ws)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride, 1)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = _conv(filters, filters, 3, 1, 1)
        self.bn2 = BatchNorm2d(filters)
        if stride != 1 or cin != filters:
            self.downsample_conv = _conv(cin, filters, 1, stride)
            self.downsample_bn = BatchNorm2d(filters)

    def forward(self, x):
        y = Fn.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return Fn.relu(y + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = _conv(filters, filters, 3, stride, 1)
        self.bn2 = BatchNorm2d(filters)
        self.conv3 = _conv(filters, filters * 4, 1)
        self.bn3 = BatchNorm2d(filters * 4)
        if stride != 1 or cin != filters * 4:
            self.downsample_conv = _conv(cin, filters * 4, 1, stride)
            self.downsample_bn = BatchNorm2d(filters * 4)

    def forward(self, x):
        y = Fn.relu(self.bn1(self.conv1(x)))
        y = Fn.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return Fn.relu(y + x)


_CONFIGS = {
    "res18": (BasicBlock, (2, 2, 2, 2)),
    "res50": (Bottleneck, (3, 4, 6, 3)),
    "res101": (Bottleneck, (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """Backbone -> (low: layer2 output, x: layer4 output), NCHW."""

    def __init__(self, variant: str = "res50"):
        super().__init__()
        block_cls, depths = _CONFIGS[variant]
        self.conv1 = StemConv()
        self.bn1 = BatchNorm2d(64)
        self.blocks = []
        cin = 64
        for stage, (depth, width) in enumerate(zip(depths, (64, 128, 256, 512))):
            stride = 1 if stage in (0, 3) else 2  # layer4 keeps stride 1
            for i in range(depth):
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block_cls(cin, width, stride if i == 0 else 1))
                self.blocks.append((stage, name))
                cin = width * block_cls.expansion
        self.low_channels = 128 * block_cls.expansion
        self.out_channels = cin

    def forward(self, x):
        x = Fn.relu(self.bn1(self.conv1(x)))
        x = Fn.max_pool2d(x, 3, 2, 1)
        low = None
        for stage, name in self.blocks:
            x = getattr(self, name)(x)
            if stage == 1:
                low = x
        return low, x


class ResNetEncoder(nn.Module):
    """NHWC images in [0, 1] -> (low NCHW, pooled (B, C) float32)."""

    def __init__(self, variant: str = "res50"):
        super().__init__()
        self.backbone = ResNet(variant)
        self.mmpool = MMPool()

    def forward(self, images: torch.Tensor):
        x = normalize_imagenet(images).permute(0, 3, 1, 2)  # channels-last NCHW view
        low, feat = self.backbone(x)
        return low, self.mmpool(feat).float()
