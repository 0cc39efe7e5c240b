"""VGG19 perceptual loss (counterpart of hifihr_tpu/losses/perceptual.py).

Imagenet-normalised inputs through VGG19's features up to relu3_2 (the six
3x3 convs of torchvision's `features[:14]`), the mean squared difference of
the two feature maps, the target branch without gradient. The VGG is a
frozen fp32 module held by the loss stack, not one of the model's
parameters.

Its pretrained weights are a data dependency: `assets/vgg19_features.npz`,
in the JAX package's layout. When the file is absent the features are
seeded random ones, drawn as flax initialises the JAX module (lecun_normal,
truncated; zero biases), and `load_or_init_vgg` warns DEGRADED, as the JAX
package's Trainer does (hifihr_tpu/utils/weights.py).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from hifihr_tpu_torch import variance_scaling_
from hifihr_tpu_torch.assets import VGG_NPZ
from hifihr_tpu_torch.networks.resnet import normalize_imagenet
from hifihr_tpu_torch.utils import profiling

_CFG = (64, 64, "M", 128, 128, "M", 256, 256)  # through relu3_2


class VGG19Features(nn.Module):
    """(B, H, W, 3) in [0, 1] -> relu3_2 feature map (B, 256, H/4, W/4)."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for v in _CFG:
            if v != "M":
                self.add_module(f"conv{i}", nn.Conv2d(cin, v, 3, padding=1))
                cin, i = v, i + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = normalize_imagenet(x).permute(0, 3, 1, 2)
        i = 0
        for v in _CFG:
            if v == "M":
                x = Fn.max_pool2d(x, 2, 2)
            else:
                x = Fn.relu(getattr(self, f"conv{i}")(x))
                i += 1
        return x


def load_or_init_vgg(device=None, seed: int = 0, path: str = VGG_NPZ) -> VGG19Features:
    """The frozen VGG19 features on `device`: converted weights from `path`
    when it exists, else seeded random ones (and a DEGRADED warning)."""
    vgg = VGG19Features()
    with torch.no_grad():
        if os.path.exists(path):
            with np.load(path) as z:
                for i in range(6):
                    conv = getattr(vgg, f"conv{i}")
                    conv.weight.copy_(torch.from_numpy(z[f"conv{i}_kernel"].transpose(3, 2, 0, 1).copy()))
                    conv.bias.copy_(torch.from_numpy(z[f"conv{i}_bias"]))
        else:
            warnings.warn(f"DEGRADED: perceptual loss: VGG19 features are RANDOM INIT (seed {seed}); convert "
                          f"torchvision's vgg19 into {path} with tools/convert_torch_weights.py vgg "
                          "(reference perceptual_loss.py:28 uses torchvision vgg19 pretrained)", stacklevel=2)
            gen = torch.Generator(device="cpu").manual_seed(seed)
            for m in vgg.modules():
                if isinstance(m, nn.Conv2d):
                    variance_scaling_(m.weight, 1.0, m.weight[0].numel(), gen)  # lecun_normal
                    m.bias.zero_()
    return vgg.requires_grad_(False).eval().to(device)


def perceptual_loss(vgg: VGG19Features, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of the VGG features; no gradient to the target."""
    with profiling.span("loss.perceptual", pred) as sp:
        f_pred = vgg(pred)
        with torch.no_grad():
            f_tgt = vgg(target)
        out = ((f_pred - f_tgt) ** 2).mean()
        sp.outputs(out)
    return out
