"""SSIM with an 11x11 gaussian window (counterpart of
hifihr_tpu/losses/ssim.py, the reference's pytorch_ssim), NHWC in.

The five local moments are one depthwise conv (`F.conv2d(..., groups=5C)`,
SAME padding, 5 each side) over the stacked [x, y, x^2, y^2, xy]; the JAX
package computes them with `lax.conv_general_dilated`, outside any Pallas
kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

from hifihr_tpu_torch import constant


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _depthwise_window(channels: int, size: int) -> np.ndarray:
    return np.ascontiguousarray(np.broadcast_to(_gaussian_window(size), (channels, 1, size, size)))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over batch, pixels and channels. Images (B, H, W, C) in [0, 1]."""
    c = img1.shape[-1]
    x = img1.permute(0, 3, 1, 2)
    y = img2.permute(0, 3, 1, 2)
    w = constant(_depthwise_window(5 * c, window_size), img1.device, img1.dtype)
    moments = Fn.conv2d(torch.cat([x, y, x * x, y * y, x * y], dim=1), w,
                        padding=window_size // 2, groups=5 * c)
    mu1, mu2, e11, e22, e12 = moments.split(c, dim=1)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()
