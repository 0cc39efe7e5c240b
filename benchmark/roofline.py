"""The yardstick of the kernel rooflines and of MFU: the H100's published
peaks and the work each kernel's call needs, counted from its inputs as the
port's chip_smoke.py counts them (frozen copies of `bound`,
`k1_ops_per_pair`, `box_pairs` and the K2 and K3 byte counts). Each input
byte is counted read once and each output byte written once."""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores (the steps turn TF32 off)
BF16_OPS_PER_S = 989e12  # bf16 tensor cores


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least time the work takes: the larger of bytes over the memory
    rate and operations over the fp32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def k1_ops_per_pair(samples: int = 3) -> int:
    """Per (pixel, face) pair: per subsample 3 edge steps + 2 min + 1
    compare, + the depth plane."""
    return 6 * samples * samples + 6


def box_pairs(bbox: torch.Tensor, size: int) -> int:
    """(pixel, face) pairs whose face box touches the pixel over a size^2
    image: the work K1 needs for these inputs, however it culls. bbox
    (B, F, 4) [umin, umax, vmin, vmax], inf for a face that never counts."""
    valid = torch.isfinite(bbox[..., 0])
    bb = torch.where(valid[..., None], bbox, torch.zeros_like(bbox))
    counts = []
    for lo, hi in ((bb[..., 0], bb[..., 1]), (bb[..., 2], bb[..., 3])):
        counts.append((hi.floor().clamp(0, size - 1) - lo.floor().clamp(0, size - 1) + 1,
                       (hi >= 0) & (lo < size)))
    n = counts[0][0] * counts[1][0]
    return int(torch.where(valid & counts[0][1] & counts[1][1], n, torch.zeros_like(n)).sum().item())


def k1_bound_s(bbox: torch.Tensor, size: int, samples: int) -> float:
    """K1 on one scene: the faces' 15-float records and boxes read, face id,
    coverage and depth written; the box pairs' operations."""
    B, F, _ = bbox.shape
    nbytes = B * F * (15 + 4) * 4 + 3 * B * size * size * 4
    return bound_s(nbytes, box_pairs(bbox, size) * k1_ops_per_pair(samples))


def k2_bound_s(table_shape: tuple, idx: torch.Tensor) -> float:
    """K2 (table (B, F, D) rows gathered by idx (B, P)): the distinct rows
    idx reads, idx and the output."""
    B, F, D = table_shape
    b_idx = torch.arange(B, device=idx.device)[:, None]
    ok = (idx >= 0) & (idx < F)
    rows = torch.unique((idx.long() + b_idx * F)[ok]).numel()
    return bound_s((rows * D + idx.numel() + idx.numel() * D) * 4)


def k3_bound_s(values_shape: tuple, idx: torch.Tensor, n_rows: int) -> float:
    """K3 (values (B, P, D) summed into n_rows rows by idx): idx, the rows
    of covered pixels, the output; one add per covered element."""
    B, P, D = values_shape
    covered = int(((idx >= 0) & (idx < n_rows)).sum().item())
    return bound_s(idx.numel() * 4 + covered * D * 4 + B * n_rows * D * 4, covered * D)


def step_bound_s(bf16_flops: float, fp32_flops: float) -> float:
    """The least time a step's matrix products and convolutions take at the
    published peaks."""
    return bf16_flops / BF16_OPS_PER_S + fp32_flops / FP32_OPS_PER_S
