"""UV texture sampling (counterpart of hifihr_tpu/render/texture.py).

`sample_texture` keeps the JAX function's contract: UV clamped to [0, 1]
and scaled by (W - 1) and (H - 1), u along the width and v along the
height with the origin at the top left, and a bilinear sample of the
edge-clamped 2 x 2 texel quad at floor(x), floor(y). Each texel's quad is
packed into one row of a (B, Ht * Wt, 4C) table, and the per-pixel fetch
of that row is K2 (`render.gather.gather_rows`), whose backward, K3,
scatter-adds each pixel's quad gradient into its row; the packing's
backward then sums the four shifted copies into the texture. On a CPU
tensor K2 is its plain version, an indexing gather. Each call is the span
`renderer.texture` (with `renderer.texture.bwd`, utils/profiling.py) and
counts one on `sample_texture.launches`.
"""

from __future__ import annotations

import math

import torch

from hifihr_tpu_torch import constant
from hifihr_tpu_torch.render.gather import gather_rows
from hifihr_tpu_torch.utils import profiling


def texel_quads(tex: torch.Tensor) -> torch.Tensor:
    """(B, Ht, Wt, C) -> (B, Ht * Wt, 4C) rows [t(y, x) | t(y, x + 1) |
    t(y + 1, x) | t(y + 1, x + 1)], the shifts clamped at the last row and
    column."""
    B, Ht, Wt, C = tex.shape
    sx = torch.cat([tex[:, :, 1:], tex[:, :, -1:]], dim=2)
    sy = torch.cat([tex[:, 1:], tex[:, -1:]], dim=1)
    sxy = torch.cat([sx[:, 1:], sx[:, -1:]], dim=1)
    return torch.cat([tex, sx, sy, sxy], dim=-1).reshape(B, Ht * Wt, 4 * C)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, 0, 1) with its gradient: half where x is at a bound
    (torch.clamp passes all of it there)."""
    return torch.minimum(torch.maximum(x, constant(0.0, x.device, x.dtype)), constant(1.0, x.device, x.dtype))


def texel_index(uv: torch.Tensor, Ht: int, Wt: int):
    """uv (B, ..., 2) -> (the quad rows' index (B, P) int32 with P the
    product of the middle dims, fx (B, ..., 1), fy (B, ..., 1))."""
    x = _clip01(uv[..., 0]) * (Wt - 1)
    y = _clip01(uv[..., 1]) * (Ht - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    idx = (y0.to(torch.int32) * Wt + x0.to(torch.int32)).reshape(uv.shape[0], -1).contiguous()
    return idx, (x - x0)[..., None], (y - y0)[..., None]


def sample_texture(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample: tex (B, Ht, Wt, C), uv (B, ..., 2) -> (B, ..., C),
    differentiable in both (in uv through the bilinear weights)."""
    B, Ht, Wt, C = tex.shape
    profiling.counters["sample_texture.launches"] += 1
    with profiling.span("renderer.texture", (tex, uv)) as sp:
        idx, fx, fy = texel_index(uv, Ht, Wt)
        q = gather_rows(texel_quads(tex).contiguous(), idx).reshape(*uv.shape[:-1], 4 * C)
        t00, t01 = q[..., 0:C], q[..., C:2 * C]
        t10, t11 = q[..., 2 * C:3 * C], q[..., 3 * C:]
        top = t00 * (1 - fx) + t01 * fx
        bot = t10 * (1 - fx) + t11 * fx
        out = top * (1 - fy) + bot * fy
        sp.outputs(out)
    return out


def cylindrical_uv(verts: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """A cylindrical unwrap around `axis`: u the angle (seam at -x), v the
    height along the axis, normalised. verts (V, 3) -> (V, 2) in [0, 1]."""
    other = [a for a in range(3) if a != axis]
    x, z, h = verts[:, other[0]], verts[:, other[1]], verts[:, axis]
    u = torch.atan2(z, x) / (2.0 * math.pi) + 0.5
    v = (h - h.min()) / (h.max() - h.min()).clamp(min=1e-8)
    return torch.stack([u, v], dim=-1)
