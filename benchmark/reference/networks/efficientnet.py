"""EfficientNet-B0..B3 image encoder (counterpart of
hifihr_tpu/networks/efficientnet.py), NCHW inside.

MBConv blocks with squeeze-excite and swish, flax's "SAME" padding (which
pads a stride-2 conv on an even size asymmetrically, so every depthwise conv
pads explicitly), BatchNorm with flax's momentum 0.99 and eps 1e-3, no
drop-connect (the JAX MBConv has none). Returns (low, feat): the output of
flattened block 4 (B, 32, 56, 56 at 224^2 for effb3), which feeds the light
estimator, and the 1536-channel head map averaged in fp32. The stem is
`StemConv(40, kernel_size=3, pad_lo=0)`, the stride-2 conv the JAX
package's space-to-depth stem stands for. Module names follow the flax
parameter paths (conv_stem, bn_stem, block{i}.expand_conv, ...), so the
converter maps names one to one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn
from torch import nn

from benchmark.reference.networks.batchnorm import BatchNorm2d
from benchmark.reference.networks.resnet import StemConv, normalize_imagenet

# (expand_ratio, channels, repeats, stride, kernel)
_BASE_BLOCKS = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
_PARAMS = {  # width, depth coefficients
    "effb0": (1.0, 1.0),
    "effb1": (1.0, 1.1),
    "effb2": (1.1, 1.2),
    "effb3": (1.2, 1.4),
}
BN_MOMENTUM, BN_EPS = 0.99, 1e-3


def _round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def same_pad(size: int, kernel: int, stride: int) -> tuple:
    """flax's "SAME" padding (lo, hi) of one spatial dim: the output has
    ceil(size / stride) positions and the low side gets the smaller half,
    e.g. (0, 1) for k = 3 and (1, 2) for k = 5 at stride 2 on an even size."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, BN_MOMENTUM, BN_EPS)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int, kernel: int,
                 se_ratio: float = 0.25):
        super().__init__()
        c_mid = in_ch * expand
        self.stride, self.kernel = stride, kernel
        self.residual = stride == 1 and in_ch == out_ch
        if expand != 1:
            self.expand_conv = nn.Conv2d(in_ch, c_mid, 1, bias=False)
            self.bn0 = _norm(c_mid)
        self.depthwise_conv = nn.Conv2d(c_mid, c_mid, kernel, stride, groups=c_mid, bias=False)
        self.bn1 = _norm(c_mid)
        se_ch = max(1, int(in_ch * se_ratio))  # from the block's input width
        self.se_reduce = nn.Conv2d(c_mid, se_ch, 1)
        self.se_expand = nn.Conv2d(se_ch, c_mid, 1)
        self.project_conv = nn.Conv2d(c_mid, out_ch, 1, bias=False)
        self.bn2 = _norm(out_ch)

    def forward(self, x):
        inp = x
        if hasattr(self, "expand_conv"):
            x = Fn.silu(self.bn0(self.expand_conv(x)))
        ph, pw = (same_pad(n, self.kernel, self.stride) for n in x.shape[2:])
        x = Fn.silu(self.bn1(self.depthwise_conv(Fn.pad(x, pw + ph))))
        # squeeze-excite; a bf16 mean accumulates in fp32
        s = x.mean((2, 3), keepdim=True)
        s = torch.sigmoid(self.se_expand(Fn.silu(self.se_reduce(s))))
        x = self.bn2(self.project_conv(x * s))
        return x + inp if self.residual else x


class EfficientNet(nn.Module):
    """Backbone -> (low: block `low_block_idx`'s output, x: the head's
    output), NCHW."""

    def __init__(self, variant: str = "effb3", low_block_idx: int = 4, cin: int = 3):
        super().__init__()
        width, depth = _PARAMS[variant]
        c_stem = _round_filters(32, width)
        self.conv_stem = StemConv(c_stem, kernel_size=3, pad_lo=0, cin=cin)
        self.bn_stem = _norm(c_stem)
        self.low_block_idx = low_block_idx
        self.n_blocks = 0
        in_ch = c_stem
        for expand, ch, reps, stride, kernel in _BASE_BLOCKS:
            out_ch = _round_filters(ch, width)
            for r in range(_round_repeats(reps, depth)):
                if self.n_blocks == low_block_idx:
                    self.low_channels = out_ch
                self.add_module(f"block{self.n_blocks}",
                                MBConv(in_ch, out_ch, expand, stride if r == 0 else 1, kernel))
                in_ch = out_ch
                self.n_blocks += 1
        self.out_channels = _round_filters(1280, width)
        self.conv_head = nn.Conv2d(in_ch, self.out_channels, 1, bias=False)
        self.bn_head = _norm(self.out_channels)

    def forward(self, x):
        x = Fn.silu(self.bn_stem(self.conv_stem(x)))
        low = None
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
            if i == self.low_block_idx:
                low = x
        return low, Fn.silu(self.bn_head(self.conv_head(x)))


class EffNetEncoder(nn.Module):
    """NHWC images in [0, 1], `cin` channels -> (low NCHW, feat (B, 1536)
    float32)."""

    def __init__(self, variant: str = "effb3", cin: int = 3):
        super().__init__()
        self.backbone = EfficientNet(variant, cin=cin)

    def forward(self, images: torch.Tensor):
        x = normalize_imagenet(images).permute(0, 3, 1, 2)  # channels-last NCHW view
        low, feat = self.backbone(x)
        return low, feat.mean((2, 3), dtype=torch.float32)
