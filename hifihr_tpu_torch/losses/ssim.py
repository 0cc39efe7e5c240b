"""SSIM with an 11x11 gaussian window (counterpart of
hifihr_tpu/losses/ssim.py, the reference's pytorch_ssim), NHWC in.

`ssim` takes a CUDA tensor through K5 (csrc/ssim.cu: the separable moments
and the value in one launch plus a fixed-order sum, and an analytic backward
in one launch; `_SSIMKernel`) or raises, and a CPU tensor through
`ssim_plain`: the five local moments as one depthwise conv
(`F.conv2d(..., groups=5C)`, SAME padding, 5 each side) over the stacked
[x, y, x^2, y^2, xy], as the JAX package computes them with
`lax.conv_general_dilated`, outside any Pallas kernel.
`ssim_partials_plain` repeats K5's arithmetic in plain PyTorch (the
separable moments, the partial maps and the analytic gradients).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn

from hifihr_tpu_torch import constant, kernels
from hifihr_tpu_torch.utils import profiling

C1, C2 = 0.01**2, 0.03**2
KERNEL_WINDOW = 11  # the only window size K5 takes


@functools.lru_cache(maxsize=8)
def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalised 1-D window (float64)."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma**2))
    return g / g.sum()


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = _gaussian_1d(size, sigma)
    return np.outer(g, g).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _depthwise_window(channels: int, size: int) -> np.ndarray:
    return np.ascontiguousarray(np.broadcast_to(_gaussian_window(size), (channels, 1, size, size)))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over batch, pixels and channels. Images (B, H, W, C) in [0, 1].

    On CUDA tensors K5 (fp32, NHWC contiguous, C <= 4, window 11) or a
    raise; the launches count on `ssim.launches` (utils/profiling.py)."""
    if not img1.is_cuda:
        return ssim_plain(img1, img2, window_size)
    _check_cuda(img1, img2, window_size)
    grad = torch.is_grad_enabled()
    with profiling.span("loss.ssim", (img1, img2)) as sp:
        out = _SSIMKernel.apply(img1, img2, grad and img1.requires_grad, grad and img2.requires_grad)
        sp.outputs(out)
    return out


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """`ssim` by the dense window's grouped conv, on any device."""
    c = img1.shape[-1]
    x = img1.permute(0, 3, 1, 2)
    y = img2.permute(0, 3, 1, 2)
    # the span starts at the permuted views (no device work), made right
    # before it, so its backward ends where their gradients are complete
    with profiling.span("loss.ssim", (x, y)) as sp:
        w = constant(_depthwise_window(5 * c, window_size), img1.device, img1.dtype)
        moments = Fn.conv2d(torch.cat([x, y, x * x, y * y, x * y], dim=1), w,
                            padding=window_size // 2, groups=5 * c)
        mu1, mu2, e11, e22, e12 = moments.split(c, dim=1)
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = e11 - mu1_sq
        sigma2_sq = e22 - mu2_sq
        sigma12 = e12 - mu12
        ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
            (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
        )
        out = ssim_map.mean()
        sp.outputs(out)
    return out


def _separable(t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """t (B, H, W, K) correlated with the 1-D window g along W, then along
    H, zero padded (SAME); each pass sums its taps in order, as K5 does."""
    p = g.numel() // 2
    _, H, W, _ = t.shape
    tp = Fn.pad(t, (0, 0, p, p))
    t = sum(g[k] * tp[:, :, k:k + W] for k in range(g.numel()))
    tp = Fn.pad(t, (0, 0, 0, 0, p, p))
    return sum(g[k] * tp[:, k:k + H] for k in range(g.numel()))


def ssim_partials_plain(img1: torch.Tensor, img2: torch.Tensor, with_dy: bool = True,
                        window_size: int = 11) -> tuple:
    """K5's arithmetic in plain PyTorch: (value, dx, dy) of the mean SSIM,
    dy None unless `with_dy`. The moments by two 1-D passes of the fp32
    window; the mean summed in float64; the partial maps a = dS/dmu_x,
    b = dS/dE[x^2] = dS/dE[y^2], c = dS/dE[xy], a' = dS/dmu_y; then
    dx = (G*a + 2 x (G*b) + y (G*c)) / N and dy = (G*a' + 2 y (G*b) +
    x (G*c)) / N, the window being symmetric."""
    g = torch.as_tensor(_gaussian_1d(window_size).astype(np.float32), dtype=img1.dtype, device=img1.device)
    c = img1.shape[-1]
    x, y = img1, img2
    mu1, mu2, e11, e22, e12 = _separable(torch.cat([x, y, x * x, y * y, x * y], dim=-1), g).split(c, dim=-1)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    a1 = 2 * mu12 + C1
    a2 = 2 * (e12 - mu12) + C2
    b1 = mu1_sq + mu2_sq + C1
    b2 = (e11 - mu1_sq) + (e22 - mu2_sq) + C2
    d = b1 * b2
    s = (a1 * a2) / d
    lean = 1.0 / b2 - 1.0 / b1
    maps = [2 * mu2 * (a2 - a1) / d + 2 * mu1 * s * lean, -s / b2, 2 * a1 / d]
    if with_dy:
        maps.append(2 * mu1 * (a2 - a1) / d + 2 * mu2 * s * lean)
    ga, gb, gc, *ga2 = _separable(torch.cat(maps, dim=-1), g).split(c, dim=-1)
    scale = 1.0 / s.numel()
    dx = scale * (ga + 2 * x * gb + y * gc)
    dy = scale * (ga2[0] + 2 * y * gb + x * gc) if with_dy else None
    return (s.sum(dtype=torch.float64) / s.numel()).to(s.dtype), dx, dy


def _check_cuda(img1: torch.Tensor, img2: torch.Tensor, window_size: int) -> None:
    if img2.device != img1.device:
        raise ValueError(f"ssim: images on {img1.device} and {img2.device}")
    if img1.dtype != torch.float32 or img2.dtype != torch.float32:
        raise TypeError(f"ssim: K5 takes float32 images, got {img1.dtype} and {img2.dtype}")
    if img1.dim() != 4 or img1.shape != img2.shape:
        raise ValueError(f"ssim: need two (B, H, W, C) images of one shape, got {tuple(img1.shape)} "
                         f"and {tuple(img2.shape)}")
    B, H, W, C = img1.shape
    if not 1 <= C <= 4 or min(B, H, W) < 1:
        raise ValueError(f"ssim: K5 takes 1 to 4 channels and a nonempty image, got {tuple(img1.shape)}")
    if not (img1.is_contiguous() and img2.is_contiguous()):
        raise ValueError("ssim: K5 takes NHWC contiguous images")
    if window_size != KERNEL_WINDOW:
        raise ValueError(f"ssim: K5 takes the {KERNEL_WINDOW}-tap window, got {window_size}")
    if img1.numel() >= 2**31:
        raise ValueError(f"ssim: shape {tuple(img1.shape)} outside K5's range")


class _SSIMKernel(torch.autograd.Function):
    """K5: the mean SSIM of two checked CUDA images. `with_dx` and `with_dy`
    say which gradients the caller wants: the forward writes the partial maps
    (a, b, c, and a' for dy) only when one is."""

    @staticmethod
    def forward(ctx, img1, img2, with_dx: bool, with_dy: bool):
        B, H, W, C = img1.shape
        dev = img1.device
        lib = kernels.load("ssim")
        stream = kernels.stream_ptr(dev)
        win = constant(_gaussian_1d(KERNEL_WINDOW).astype(np.float32), dev)
        n_maps = 4 if with_dy else 3 if with_dx else 0
        maps = torch.empty((n_maps, B, H, W, C), dtype=torch.float32, device=dev)
        partial = torch.empty(lib.hifihr_ssim_blocks(B, H, W, C), dtype=torch.float64, device=dev)
        kernels.check(lib.hifihr_ssim_forward(img1.data_ptr(), img2.data_ptr(), win.data_ptr(), B, H, W, C,
                                              n_maps, partial.data_ptr(), maps.data_ptr(), stream), "ssim forward")
        profiling.counters["ssim.launches"] += 1
        out = torch.empty((), dtype=torch.float32, device=dev)
        kernels.check(lib.hifihr_ssim_sum(partial.data_ptr(), partial.numel(), img1.numel(), out.data_ptr(),
                                          stream), "ssim sum")
        profiling.counters["ssim.launches"] += 1
        if n_maps:
            ctx.save_for_backward(img1, img2, maps, win)
        ctx.with_dx, ctx.with_dy = with_dx, with_dy
        return out

    @staticmethod
    def backward(ctx, grad):
        img1, img2, maps, win = ctx.saved_tensors
        B, H, W, C = img1.shape
        grad = grad.contiguous()
        dx = torch.empty_like(img1)
        dy = torch.empty_like(img2) if ctx.with_dy else None
        err = kernels.load("ssim").hifihr_ssim_backward(
            img1.data_ptr(), img2.data_ptr(), maps.data_ptr(), win.data_ptr(), grad.data_ptr(), B, H, W, C,
            int(ctx.with_dy), dx.data_ptr(), 0 if dy is None else dy.data_ptr(), kernels.stream_ptr(img1.device))
        kernels.check(err, "ssim backward")
        profiling.counters["ssim.launches"] += 1
        return (dx if ctx.with_dx else None), dy, None, None
