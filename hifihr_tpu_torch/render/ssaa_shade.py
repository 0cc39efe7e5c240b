"""K6: the SSAA shade pass in one CUDA kernel pair (csrc/ssaa_shade.cu).

K6 replaces no Pallas kernel. In the SSAA path it takes over the work of
K2's per-fragment fetches, of K3's scatter behind them, and of the
XLA-fused jnp shade of hifihr_tpu/render/renderer.py: the barycentric
recompute, the interpolation of the per-vertex channels and of the atlas
corners, the bilinear UV sample, the Phong shading with the normal and spec
maps, and the aa x aa average pool, in one forward launch; and their
analytic backward in one launch, which recomputes each covered fragment in
registers, so nothing of the supersampled size is saved but K4's face ids
(no checkpoint recompute). K2 and K3 stay for the MSAA paths.

`ssaa_shade` takes CUDA tensors through K6 (`_SSAAShadeKernel`) or raises
(`check_inputs`); the renderer sends a CPU tensor down the plain composed
path instead (`PhongRenderer._shade_plain` under `torch.utils.checkpoint`).
`ssaa_shade_partials_plain` repeats K6's arithmetic, forward and the
hand-derived backward, in plain PyTorch over the covered fragments, with
`index_add_` where the kernel adds atomically.

Contract. face_id (B, S, S) int32 from K4 (-1 on background), S a multiple
of aa; the per-vertex table (B, V, R) fp32 whose row is [u, v, z | the
renderer's `_assemble` channels with the points | zeros], R = 3 + D
rounded up to a multiple of 4, by `LAYOUTS[kind, with_maps]`; faces (F, 3)
int64; the per-face atlas corners (F, 3, 2) for the `atlas` kind; the UV
maps (B, Ht, Wt, C) fp32 contiguous, C >= 7 with the maps, else C >= 3,
for `atlas` and `chart`; the light (B, 12) [ambient, 0.8 diffuse, 0.2
specular, unit direction] (`light_vector`) -> (B, S / aa, S / aa, 5)
[rgb * mask, mask, z * covered], each the mean of its aa x aa block. Each
covered fragment is render/interpolate.py's `barycentric_coords` (area
guard 1e-12, z guard 1e-8, denominator guard 1e-12, clamp to [-4, 5]),
`interpolate_attribute` and `interpolate_face_attribute`, texture.py's
`sample_texture` (UV clipped to [0, 1], the edge-clamped bilinear quad) and
shading.py's `phong_shade`; the backward takes torch's subgradients of each
(the clamps pass the gradient at their bounds, `_clip01` half of it,
`torch.where` guards none, pow(0, 30)' = 0, no specular gradient where
N.L <= 0).

Counter (utils/profiling.py): `ssaa_shade.kernel_launches`, one a launch
(two an SSAA train step, one an eval render).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hifihr_tpu_torch import kernels
from hifihr_tpu_torch.render.shading import MAT_AMBIENT, MAT_DIFFUSE, MAT_SPECULAR, _safe_normalize
from hifihr_tpu_torch.utils import profiling

KINDS = ("colors", "atlas", "chart")  # vertex colours; UV from a per-face atlas; UV from a per-vertex chart


class Layout(NamedTuple):
    """Offsets of the channels in a table row (-1 where absent)."""

    color: int
    uv: int
    tangent: int
    normal: int
    point: int
    width: int  # R: the row's floats, 3 + D rounded up to a multiple of 4


def _layout(kind: str, with_maps: bool) -> Layout:
    off = 3
    color = uv = tangent = -1
    if kind == "colors":
        color, off = off, off + 3
    elif kind == "chart":
        uv, off = off, off + 2
    if with_maps:
        tangent, off = off, off + 3
    normal, point = off, off + 3
    return Layout(color, uv, tangent, normal, point, (point + 3 + 3) // 4 * 4)


LAYOUTS = {(k, m): _layout(k, m) for k in KINDS for m in (False, True) if not (k == "colors" and m)}


def light_vector(light) -> torch.Tensor:
    """A DirectionalLight -> (B, 12) [ambient, 0.8 diffuse, 0.2 specular,
    unit direction], each term rounded as `phong_shade` rounds it."""
    return torch.cat([MAT_AMBIENT * light.ambient_color, MAT_DIFFUSE * light.diffuse_color,
                      MAT_SPECULAR * light.specular_color, _safe_normalize(light.direction)], dim=-1)


def shade_table(verts_screen: torch.Tensor, attrs: torch.Tensor, width: int) -> torch.Tensor:
    """(B, V, 3) screen vertices and (B, V, D) channels -> the (B, V, width)
    table, zero padded."""
    B, V, _ = verts_screen.shape
    parts = [verts_screen, attrs]
    pad = width - 3 - attrs.shape[-1]
    if pad:
        parts.append(verts_screen.new_zeros((B, V, pad)))
    return torch.cat(parts, dim=-1).contiguous()


def ssaa_shade(face_id: torch.Tensor, verts_screen: torch.Tensor, attrs: torch.Tensor, faces: torch.Tensor,
               light, aa: int, kind: str, with_maps: bool, face_uv: torch.Tensor | None = None,
               texture: torch.Tensor | None = None) -> torch.Tensor:
    """K6: the pooled SSAA render (B, S / aa, S / aa, 5) of K4's face_id
    with the channels `attrs` of `_assemble` (points included), shaded by
    the DirectionalLight `light`; differentiable in verts_screen, attrs,
    texture and the light. CUDA tensors only: anything K6 does not take
    raises (`check_inputs`)."""
    lay = check_inputs(face_id, verts_screen, attrs, faces, aa, kind, with_maps, face_uv, texture)
    table = shade_table(verts_screen, attrs, lay.width)
    lvec = light_vector(light).contiguous()
    if lvec.shape != (face_id.shape[0], 12) or lvec.dtype != torch.float32:
        raise ValueError(f"ssaa_shade: the light must give (B, 12) float32, got {tuple(lvec.shape)} {lvec.dtype}")
    return _SSAAShadeKernel.apply(table, texture, lvec, face_id, faces, face_uv, aa, kind, with_maps)


def check_inputs(face_id, verts_screen, attrs, faces, aa: int, kind: str, with_maps: bool, face_uv, texture) -> Layout:
    """Raise on what K6 does not take: TypeError on a dtype, ValueError on a
    shape, a layout, a non-contiguous input, a size past 32-bit indexing or
    a tensor off the card. Returns the table's layout."""
    if (kind, with_maps) not in LAYOUTS:
        raise ValueError(f"ssaa_shade: no K6 plan for kind {kind!r} with maps {with_maps}")
    lay = LAYOUTS[kind, with_maps]
    if face_id.dtype != torch.int32:
        raise TypeError(f"ssaa_shade: K6 takes int32 face ids, got {face_id.dtype}")
    if faces.dtype != torch.int64:
        raise TypeError(f"ssaa_shade: K6 takes int64 faces, got {faces.dtype}")
    for name, t in (("verts_screen", verts_screen), ("attrs", attrs), ("face_uv", face_uv), ("texture", texture)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssaa_shade: K6 takes float32 {name}, got {t.dtype}")
    if face_id.dim() != 3 or face_id.shape[1] != face_id.shape[2]:
        raise ValueError(f"ssaa_shade: face_id must be (B, S, S), got {tuple(face_id.shape)}")
    B, S = face_id.shape[:2]
    if not isinstance(aa, int) or aa < 1 or S % aa:
        raise ValueError(f"ssaa_shade: the supersampled size {S} must be a multiple of aa = {aa}")
    if verts_screen.dim() != 3 or verts_screen.shape[0] != B or verts_screen.shape[2] != 3:
        raise ValueError(f"ssaa_shade: verts_screen must be ({B}, V, 3), got {tuple(verts_screen.shape)}")
    if attrs.dim() != 3 or attrs.shape[:2] != verts_screen.shape[:2] or 3 + attrs.shape[2] != lay.point + 3:
        raise ValueError(f"ssaa_shade: the {kind} plan (maps {with_maps}) takes ({B}, V, {lay.point}) channels, "
                         f"got {tuple(attrs.shape)}")
    if faces.dim() != 2 or faces.shape[1] != 3:
        raise ValueError(f"ssaa_shade: faces must be (F, 3), got {tuple(faces.shape)}")
    F = faces.shape[0]
    if (kind == "atlas") != (face_uv is not None) or (face_uv is not None and tuple(face_uv.shape) != (F, 3, 2)):
        raise ValueError(f"ssaa_shade: the {kind} plan takes {'(F, 3, 2) atlas corners' if kind == 'atlas' else 'no atlas'}"
                         f", got {None if face_uv is None else tuple(face_uv.shape)}")
    if (kind == "colors") != (texture is None):
        raise ValueError(f"ssaa_shade: the {kind} plan {'takes no' if kind == 'colors' else 'needs the'} UV maps")
    if texture is not None:
        need = 7 if with_maps else 3
        if texture.dim() != 4 or texture.shape[0] != B or texture.shape[3] < need:
            raise ValueError(f"ssaa_shade: the maps must be ({B}, Ht, Wt, >= {need}), got {tuple(texture.shape)}")
    for name, t in (("face_id", face_id), ("faces", faces), ("face_uv", face_uv), ("texture", texture)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"ssaa_shade: K6 takes a contiguous {name}")
    if B > 65535 or face_id.numel() >= 2**31 or B * verts_screen.shape[1] * lay.width >= 2**31 \
            or (texture is not None and texture.numel() >= 2**31):
        raise ValueError(f"ssaa_shade: shapes past K6's 32-bit indexing: face_id {tuple(face_id.shape)}, "
                         f"V {verts_screen.shape[1]}, texture {None if texture is None else tuple(texture.shape)}")
    devices = {t.device for t in (face_id, verts_screen, attrs, faces, face_uv, texture) if t is not None}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"ssaa_shade: K6 takes tensors on one CUDA device, got {sorted(map(str, devices))}")
    return lay


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _launch(fn: str, face_id, faces, face_uv, texture, table, light, aa: int, kind: str, with_maps: bool,
            *buffers) -> None:
    B, S = face_id.shape[:2]
    ht, wt, c = texture.shape[1:] if texture is not None else (0, 0, 0)
    err = getattr(kernels.load("ssaa_shade"), fn)(
        KINDS.index(kind), int(with_maps), _ptr(face_id), _ptr(faces), faces.shape[0], _ptr(face_uv),
        _ptr(table), table.shape[1], table.shape[2], _ptr(texture), ht, wt, c, _ptr(light), B, S, aa,
        *(_ptr(b) for b in buffers), kernels.stream_ptr(face_id.device))
    kernels.check(err, f"ssaa_shade {fn}")
    profiling.counters["ssaa_shade.kernel_launches"] += 1


class _SSAAShadeKernel(torch.autograd.Function):
    """K6 on checked CUDA inputs. Saves the inputs (face_id the only one of
    the supersampled size) and recomputes each fragment in backward."""

    @staticmethod
    def forward(ctx, table, texture, light, face_id, faces, face_uv, aa, kind, with_maps):
        B, S = face_id.shape[:2]
        out = torch.empty((B, S // aa, S // aa, 5), dtype=torch.float32, device=table.device)
        _launch("hifihr_ssaa_shade_forward", face_id, faces, face_uv, texture, table, light, aa, kind, with_maps,
                out)
        ctx.save_for_backward(table, texture, light, face_id, faces, face_uv)
        ctx.meta = (aa, kind, with_maps)
        return out

    @staticmethod
    def backward(ctx, grad):
        table, texture, light, face_id, faces, face_uv = ctx.saved_tensors
        aa, kind, with_maps = ctx.meta
        need_table, need_tex, need_light = ctx.needs_input_grad[:3]
        g_table = torch.zeros_like(table)  # the fragments' corner gradients land here even when unwanted
        g_tex = torch.zeros_like(texture) if need_tex else None
        g_light = torch.zeros_like(light) if need_light else None
        _launch("hifihr_ssaa_shade_backward", face_id, faces, face_uv, texture, table, light, aa, kind, with_maps,
                grad.contiguous(), g_table, g_tex, g_light)
        return (g_table if need_table else None), g_tex, g_light, None, None, None, None, None, None


def _clip01_grad(x: torch.Tensor) -> torch.Tensor:
    """d clip(x, 0, 1) / dx as texture.py's `_clip01` takes it: 1 inside,
    1/2 at a bound, 0 outside."""
    inside = ((x > 0) & (x < 1)).to(x.dtype)
    return inside + 0.5 * ((x == 0) | (x == 1)).to(x.dtype)


def _norm_bwd(x: torch.Tensor, r: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient of y = x r, r = (|x|^2 + eps)^(-1/2), at dy (rows)."""
    return r * dy - (r * r * r) * (x * dy).sum(-1, keepdim=True) * x


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=True)


def ssaa_shade_partials_plain(face_id: torch.Tensor, table: torch.Tensor, faces: torch.Tensor,
                              face_uv: torch.Tensor | None, texture: torch.Tensor | None, light: torch.Tensor,
                              aa: int, kind: str, with_maps: bool, grad_out: torch.Tensor | None = None) -> tuple:
    """K6's arithmetic in plain PyTorch, over the covered fragments: (out,
    d_table, d_texture, d_light) for the table, maps and light of
    `_SSAAShadeKernel` and the output's gradient `grad_out` (the gradients
    None without it, d_texture None without maps). Any dtype and device."""
    lay = LAYOUTS[kind, with_maps]
    B, S = face_id.shape[:2]
    Ho = S // aa
    dt = table.dtype
    flat = face_id.reshape(B, S * S)
    bi, pi = (flat >= 0).nonzero(as_tuple=True)
    f = flat[bi, pi].long()
    col, row = pi % S, pi // S
    u, v = col.to(dt)[:, None] + 0.5, row.to(dt)[:, None] + 0.5
    vid = faces.long()[f]  # (N, 3)
    rows = table[bi[:, None], vid]  # (N, 3, R)
    px, py, pz = rows[:, :, 0], rows[:, :, 1], rows[:, :, 2]

    # barycentric_coords: e_k = E(corner k + 1, corner k + 2)
    def edge(p: int, q: int) -> torch.Tensor:
        return (px[:, q:q + 1] - px[:, p:p + 1]) * (v - py[:, p:p + 1]) \
            - (py[:, q:q + 1] - py[:, p:p + 1]) * (u - px[:, p:p + 1])

    e = torch.cat([edge(1, 2), edge(2, 0), edge(0, 1)], dim=-1)
    area = e[:, 0:1] + e[:, 1:2] + e[:, 2:3]
    area_ok = area.abs() >= 1e-12
    area_s = torch.where(area_ok, area, torch.full_like(area, 1e-12))
    w = e / area_s
    z_ok = pz.abs() >= 1e-8
    z_s = torch.where(z_ok, pz, torch.full_like(pz, 1e-8))
    wp = w / z_s
    den = wp[:, 0:1] + wp[:, 1:2] + wp[:, 2:3]
    den_ok = den.abs() >= 1e-12
    den_s = torch.where(den_ok, den, torch.full_like(den, 1e-12))
    braw = wp / den_s
    bary = braw.clamp(-4.0, 5.0)
    attr = rows[:, :, 3:]  # (N, 3, R - 3)
    P = (bary[:, :, None] * attr).sum(1)  # (N, R - 3); the pad reads 0

    def ch(off: int, n: int) -> torch.Tensor:
        return P[:, off - 3:off - 3 + n]

    L = light[bi]
    amb, dif, spe, l = L[:, 0:3], L[:, 3:6], L[:, 6:9], L[:, 9:12]
    if kind != "colors":
        uv = (bary[:, :, None] * face_uv[f].to(dt)).sum(1) if kind == "atlas" else ch(lay.uv, 2)
        Ht, Wt = texture.shape[1:3]
        nt = 7 if with_maps else 3
        cu, cv = uv[:, 0:1].clamp(0.0, 1.0), uv[:, 1:2].clamp(0.0, 1.0)
        x, y = cu * (Wt - 1), cv * (Ht - 1)
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        ix0, iy0 = x0[:, 0].long(), y0[:, 0].long()
        ix1, iy1 = (ix0 + 1).clamp(max=Wt - 1), (iy0 + 1).clamp(max=Ht - 1)
        t00, t01 = texture[bi, iy0, ix0, :nt], texture[bi, iy0, ix1, :nt]
        t10, t11 = texture[bi, iy1, ix0, :nt], texture[bi, iy1, ix1, :nt]
        top = t00 * (1 - fx) + t01 * fx
        bot = t10 * (1 - fx) + t11 * fx
        samp = top * (1 - fy) + bot * fy
        T = samp[:, 0:3]
    else:
        T = ch(lay.color, 3)
    Nr, Q = ch(lay.normal, 3), ch(lay.point, 3)
    r0 = torch.rsqrt(_dot(Nr, Nr) + 1e-12)
    n0 = Nr * r0
    if with_maps:
        Tg = ch(lay.tangent, 3)
        s = _dot(Tg, n0)
        tp = Tg - s * n0
        rt = torch.rsqrt(_dot(tp, tp) + 1e-12)
        t = tp * rt
        bt = torch.linalg.cross(n0, t)
        nm = samp[:, 3:6] * 2.0 - 1.0
        SM = samp[:, 6:7]
        m = t * nm[:, 0:1] + bt * nm[:, 1:2] + n0 * nm[:, 2:3]
        rm = torch.rsqrt(_dot(m, m) + 1e-12)
        n = m * rm
    else:
        n = n0
    ndl_raw = _dot(n, l)
    ndl = ndl_raw.clamp(min=0.0)
    rq = torch.rsqrt(_dot(Q, Q) + 1e-12)
    view = -(Q * rq)
    refl = -l + 2.0 * ndl_raw * n
    ca_raw = _dot(view, refl)
    ca = torch.where(ndl > 0, ca_raw.clamp(min=0.0), torch.zeros_like(ca_raw))
    pw = torch.pow(ca, 30.0)
    spec = spe * pw
    if with_maps:
        spec = spec * SM
    rgb = T * (amb + dif * ndl) + spec

    pooled = bi * Ho * Ho + (row // aa) * Ho + col // aa
    sample = torch.cat([rgb, torch.ones_like(ca), Q[:, 2:3]], dim=-1)
    out = table.new_zeros((B * Ho * Ho, 5)).index_add_(0, pooled, sample) / (aa * aa)
    out = out.reshape(B, Ho, Ho, 5)
    if grad_out is None:
        return out, None, None, None

    g = grad_out.reshape(B * Ho * Ho, 5)[pooled] / (aa * aa)
    gs = g[:, 0:3]
    dP = torch.zeros_like(P)
    dP[:, lay.point - 3 + 2] += g[:, 4]
    dT = gs * (amb + dif * ndl)
    d_amb, d_dif = gs * T, gs * T * ndl
    d_ndl = _dot(gs * T, dif)
    if with_maps:
        d_spe, d_SM, d_pw = gs * SM * pw, _dot(gs, spe * pw), _dot(gs * SM, spe)
    else:
        d_spe, d_pw = gs * pw, _dot(gs, spe)
    d_ca = torch.where(ndl > 0, d_pw * 30.0 * torch.pow(ca, 29.0), torch.zeros_like(d_pw))
    d_ca = torch.where(ca_raw >= 0, d_ca, torch.zeros_like(d_ca))
    d_view, d_refl = d_ca * refl, d_ca * view
    d_l = -d_refl
    d_ndl_raw = 2.0 * _dot(d_refl, n) + torch.where(ndl_raw >= 0, d_ndl, torch.zeros_like(d_ndl))
    d_n = 2.0 * ndl_raw * d_refl + d_ndl_raw * l
    d_l = d_l + d_ndl_raw * n
    dP[:, lay.point - 3:lay.point] += _norm_bwd(Q, rq, -d_view)
    if with_maps:
        d_m = _norm_bwd(m, rm, d_n)
        d_t, d_bt, d_n0 = d_m * nm[:, 0:1], d_m * nm[:, 1:2], d_m * nm[:, 2:3]
        d_NM = 2.0 * torch.cat([_dot(d_m, t), _dot(d_m, bt), _dot(d_m, n0)], dim=-1)
        d_n0 = d_n0 + torch.linalg.cross(t, d_bt)
        d_t = d_t + torch.linalg.cross(d_bt, n0)
        d_tp = _norm_bwd(tp, rt, d_t)
        d_s = -_dot(d_tp, n0)
        dP[:, lay.tangent - 3:lay.tangent] += d_tp + d_s * n0
        d_n0 = d_n0 - s * d_tp + d_s * Tg
    else:
        d_n0 = d_n
    dP[:, lay.normal - 3:lay.normal] += _norm_bwd(Nr, r0, d_n0)
    d_bary = torch.zeros_like(bary)
    d_tex = None
    if kind != "colors":
        d_samp = torch.cat([dT, d_NM, d_SM], dim=-1) if with_maps else dT
        d_top, d_bot = d_samp * (1 - fy), d_samp * fy
        d_tex = torch.zeros_like(texture)
        flat_tex = d_tex.view(-1, texture.shape[-1])
        for iy, ix, d in ((iy0, ix0, d_top * (1 - fx)), (iy0, ix1, d_top * fx), (iy1, ix0, d_bot * (1 - fx)),
                          (iy1, ix1, d_bot * fx)):
            flat_tex[:, :nt].index_add_(0, (bi * Ht + iy) * Wt + ix, d)
        d_fx = _dot(d_top, t01 - t00) + _dot(d_bot, t11 - t10)
        d_fy = _dot(d_samp, bot - top)
        d_uv = torch.cat([d_fx * (Wt - 1) * _clip01_grad(uv[:, 0:1]),
                          d_fy * (Ht - 1) * _clip01_grad(uv[:, 1:2])], dim=-1)
        if kind == "atlas":
            d_bary = d_bary + (d_uv[:, None, :] * face_uv[f].to(dt)).sum(-1)
        else:
            dP[:, lay.uv - 3:lay.uv - 1] += d_uv
    else:
        dP[:, lay.color - 3:lay.color] += dT
    d_attr = bary[:, :, None] * dP[:, None, :]  # (N, 3, R - 3)
    d_bary = d_bary + (attr * dP[:, None, :]).sum(-1)
    d_braw = torch.where((braw >= -4.0) & (braw <= 5.0), d_bary, torch.zeros_like(d_bary))
    d_wp = d_braw / den_s
    d_den = torch.where(den_ok, -_dot(d_braw, wp) / (den_s * den_s), torch.zeros_like(den))
    d_wp = d_wp + d_den
    d_w = d_wp / z_s
    d_z = torch.where(z_ok, -d_wp * w / (z_s * z_s), torch.zeros_like(pz))
    d_e = d_w / area_s
    d_area = torch.where(area_ok, -_dot(d_w, e) / (area_s * area_s), torch.zeros_like(area))
    d_e = d_e + d_area
    # E(p, q) = (q_x - p_x)(v - p_y) - (q_y - p_y)(u - p_x)
    d_x, d_y = torch.zeros_like(px), torch.zeros_like(py)
    for k, (p, q) in enumerate(((1, 2), (2, 0), (0, 1))):
        de = d_e[:, k:k + 1]
        d_x[:, q:q + 1] += de * (v - py[:, p:p + 1])
        d_y[:, q:q + 1] -= de * (u - px[:, p:p + 1])
        d_x[:, p:p + 1] += de * ((py[:, q:q + 1] - py[:, p:p + 1]) - (v - py[:, p:p + 1]))
        d_y[:, p:p + 1] += de * ((u - px[:, p:p + 1]) - (px[:, q:q + 1] - px[:, p:p + 1]))
    d_rows = torch.cat([torch.stack([d_x, d_y, d_z], dim=-1), d_attr], dim=-1)  # (N, 3, R)
    V, R = table.shape[1:]
    d_table = table.new_zeros((B * V, R)).index_add_(0, (bi[:, None] * V + vid).reshape(-1), d_rows.reshape(-1, R))
    d_light = light.new_zeros(light.shape).index_add_(0, bi, torch.cat([d_amb, d_dif, d_spe, d_l], dim=-1))
    return out, d_table.reshape(table.shape), d_tex, d_light
