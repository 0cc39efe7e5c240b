"""HRNet-W18-small-v2 encoder (counterpart of hifihr_tpu/networks/hrnet.py),
NCHW inside.

The reference's timm `hrnet_w18_small_v2` with features_only/out_indices=[4]
(network/res_encoder.py:375-394): a stride-4 stem, multi-resolution
branches with repeated fusion, then the classification head (incremental
bottlenecks and a strided downsample merge), giving a (B, 1024, 7, 7) map
at 224^2 that MMPool pools to 1024 features. HRNet has no 28x28 low-level
tap, so the encoder returns low=None and the model builds no light
estimator and shades with the default light (res_encoder.py:391-394).

The stem's first conv is `StemConv(64, kernel_size=3, pad_lo=1)`, the
stride-2 conv the JAX package's space-to-depth StemConvS2D stands for.
Module names follow the flax paths (`stage{s}_mod{m}.branch{b}_block{k}`,
`stage{s}_mod{m}.fuse.up_{i}_{j}_conv`, `t{s}_conv{b}`, `incre{i}`,
`downsamp{i}_conv`, ...) and are registered in the order flax creates them,
so the converter maps names one to one and a warm start's suffix match
picks what the JAX package's picks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch import nn

from hifihr_tpu_torch.networks.batchnorm import BatchNorm2d
from hifihr_tpu_torch.networks.heads import MMPool
from hifihr_tpu_torch.networks.resnet import BasicBlock, Bottleneck, StemConv, normalize_imagenet

# hrnet_w18_small_v2: (num_modules, num_branches, num_blocks, channels)
_STAGES = [
    (1, 2, (2, 2), (18, 36)),
    (3, 3, (2, 2, 2), (18, 36, 72)),
    (2, 4, (2, 2, 2, 2), (18, 36, 72, 144)),
]
_HEAD_CHANNELS = (32, 64, 128, 256)  # incre bottleneck widths (x4 expansion)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class FuseLayer(nn.Module):
    """Every output branch sums the contributions of every input branch:
    a 1x1 conv, BatchNorm and nearest upsampling from a coarser branch, a
    chain of strided 3x3 convs from a finer one."""

    def __init__(self, channels: tuple):
        super().__init__()
        self.n = n = len(channels)
        for i in range(n):
            for j in range(n):
                if j > i:
                    self.add_module(f"up_{i}_{j}_conv", _conv(channels[j], channels[i], 1))
                    self.add_module(f"up_{i}_{j}_bn", BatchNorm2d(channels[i]))
                for k in range(i - j):
                    cout = channels[i] if k == i - j - 1 else channels[j]
                    self.add_module(f"down_{i}_{j}_{k}_conv", _conv(channels[j], cout, 3, 2))
                    self.add_module(f"down_{i}_{j}_{k}_bn", BatchNorm2d(cout))

    def forward(self, xs: list) -> list:
        outs = []
        for i in range(self.n):
            acc = None
            for j in range(self.n):
                y = xs[j]
                if j > i:
                    y = getattr(self, f"up_{i}_{j}_bn")(getattr(self, f"up_{i}_{j}_conv")(y))
                    # jax.image.resize "nearest" samples at half-pixel centres
                    y = Fn.interpolate(y, size=xs[i].shape[2:], mode="nearest-exact")
                for k in range(i - j):
                    y = getattr(self, f"down_{i}_{j}_{k}_bn")(getattr(self, f"down_{i}_{j}_{k}_conv")(y))
                    if k < i - j - 1:
                        y = Fn.relu(y)
                acc = y if acc is None else acc + y
            outs.append(Fn.relu(acc))
        return outs


class HRModule(nn.Module):
    def __init__(self, channels: tuple, num_blocks: tuple):
        super().__init__()
        self.num_blocks = num_blocks
        for b, ch in enumerate(channels):
            for k in range(num_blocks[b]):
                self.add_module(f"branch{b}_block{k}", BasicBlock(ch, ch))
        self.fuse = FuseLayer(channels)

    def forward(self, xs: list) -> list:
        ys = []
        for b, x in enumerate(xs):
            for k in range(self.num_blocks[b]):
                x = getattr(self, f"branch{b}_block{k}")(x)
            ys.append(x)
        return self.fuse(ys)


class HRNet(nn.Module):
    """Backbone -> the head's (B, 1024, S/32, S/32) map, NCHW."""

    low_channels = None  # no low-level tap, so no light estimator
    out_channels = _HEAD_CHANNELS[-1] * 4

    def __init__(self, cin: int = 3):
        super().__init__()
        self.conv1 = StemConv(64, kernel_size=3, pad_lo=1, cin=cin)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = BatchNorm2d(64)
        self.layer1_0 = Bottleneck(64, 64)
        self.layer1_1 = Bottleneck(256, 64)
        # per stage: ("keep" | "adapt" | "new", branch) transitions, then modules
        self.plan = []
        prev = [256]
        for s, (num_modules, num_branches, num_blocks, channels) in enumerate(_STAGES):
            trans = []
            for b in range(num_branches):
                if b < len(prev):
                    if prev[b] == channels[b]:
                        trans.append("keep")
                        continue
                    self.add_module(f"t{s}_conv{b}", _conv(prev[b], channels[b], 3))
                    trans.append("adapt")
                else:  # a new, coarser branch from the coarsest old one
                    self.add_module(f"t{s}_conv{b}", _conv(prev[-1], channels[b], 3, 2))
                    trans.append("new")
                self.add_module(f"t{s}_bn{b}", BatchNorm2d(channels[b]))
            for m in range(num_modules):
                self.add_module(f"stage{s}_mod{m}", HRModule(channels, num_blocks))
            self.plan.append((trans, num_modules))
            prev = list(channels)
        self.incre0 = Bottleneck(prev[0], _HEAD_CHANNELS[0])
        for i in range(1, 4):
            self.add_module(f"incre{i}", Bottleneck(prev[i], _HEAD_CHANNELS[i]))
            self.add_module(f"downsamp{i}_conv", _conv(_HEAD_CHANNELS[i - 1] * 4, _HEAD_CHANNELS[i] * 4, 3, 2))
            self.add_module(f"downsamp{i}_bn", BatchNorm2d(_HEAD_CHANNELS[i] * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = Fn.relu(self.bn1(self.conv1(x)))
        x = Fn.relu(self.bn2(self.conv2(x)))
        branches = [self.layer1_1(self.layer1_0(x))]
        for s, (trans, num_modules) in enumerate(self.plan):
            new = []
            for b, kind in enumerate(trans):
                if kind == "keep":
                    new.append(branches[b])
                    continue
                src = branches[b] if kind == "adapt" else branches[-1]
                new.append(Fn.relu(getattr(self, f"t{s}_bn{b}")(getattr(self, f"t{s}_conv{b}")(src))))
            branches = new
            for m in range(num_modules):
                branches = getattr(self, f"stage{s}_mod{m}")(branches)
        y = self.incre0(branches[0])
        for i in range(1, 4):
            z = getattr(self, f"incre{i}")(branches[i])
            y = Fn.relu(getattr(self, f"downsamp{i}_bn")(getattr(self, f"downsamp{i}_conv")(y)))
            y = y + z
        return y


class HRNetEncoder(nn.Module):
    """NHWC images in [0, 1], `cin` channels -> (None, pooled (B, 1024)
    float32)."""

    def __init__(self, cin: int = 3):
        super().__init__()
        self.backbone = HRNet(cin)
        self.mmpool = MMPool()

    def forward(self, images: torch.Tensor):
        x = normalize_imagenet(images).permute(0, 3, 1, 2)  # channels-last NCHW view
        return None, self.mmpool(self.backbone(x)).float()
