"""Host-side affine crop and rotation math for the data loaders, in numpy
(counterpart of hifihr_tpu/geometry/crops.py, copied function for function,
so both packages give the same bytes).

Semantics follow the reference's utils/handutils.py:63-124 (the K update
`post_rot_trans @ K` depends on this exact construction). uint8 images warp
through the port's native library (data/native.py); float images through
the numpy bilinear path below.
"""

from __future__ import annotations

import numpy as np


def get_annot_scale(annots: np.ndarray, scale_factor: float = 2.2) -> float:
    mins = annots.min(0)
    maxs = annots.max(0)
    return float(max(maxs[0] - mins[0], maxs[1] - mins[1]) * scale_factor)


def get_annot_center(annots: np.ndarray) -> np.ndarray:
    mins = annots.min(0)
    maxs = annots.max(0)
    return np.asarray([int((maxs[0] + mins[0]) / 2), int((maxs[1] + mins[1]) / 2)])


def get_affine_trans_no_rot(center, scale: float, res) -> np.ndarray:
    t = np.zeros((3, 3))
    t[0, 0] = float(res[1]) / scale
    t[1, 1] = float(res[0]) / scale
    t[0, 2] = res[1] * (-float(center[0]) / scale + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / scale + 0.5)
    t[2, 2] = 1
    return t


def get_affine_transform(center, scale: float, res, rot: float = 0.0):
    """Returns (total_trans, post_rot_trans) as in the reference.

    total_trans maps original-image pixels -> crop pixels (incl. rotation);
    post_rot_trans is the no-rot crop around the rotated center, used to
    update K: K' = post_rot_trans @ K (data/dataset.py:262).
    """
    rot_mat = np.zeros((3, 3))
    sn, cs = np.sin(rot), np.cos(rot)
    rot_mat[0, :2] = [cs, -sn]
    rot_mat[1, :2] = [sn, cs]
    rot_mat[2, 2] = 1
    center_h = np.asarray(list(center) + [1.0])
    origin_rot_center = rot_mat @ center_h

    t_mat = np.eye(3)
    t_mat[0, 2] = -res[1] / 2
    t_mat[1, 2] = -res[0] / 2
    t_inv = t_mat.copy()
    t_inv[:2, 2] *= -1
    transformed_center = t_inv @ rot_mat @ t_mat @ center_h

    post_rot_trans = get_affine_trans_no_rot(origin_rot_center[:2], scale, res)
    total_trans = post_rot_trans @ rot_mat
    affinetrans_post_rot = get_affine_trans_no_rot(transformed_center[:2], scale, res)
    return total_trans.astype(np.float32), affinetrans_post_rot.astype(np.float32)


def transform_coords(pts: np.ndarray, affine_trans: np.ndarray, invert: bool = False) -> np.ndarray:
    if invert:
        affine_trans = np.linalg.inv(affine_trans)
    hom = np.concatenate([pts, np.ones((np.asarray(pts).shape[0], 1))], axis=1)
    return (affine_trans @ hom.T).T[:, :2]


def resized_crop(img: np.ndarray, top: float, left: float, height: float,
                 width: float, res, out_u8: bool = False) -> np.ndarray:
    """Crop a (possibly out-of-bounds, zero-padded) box and resize to res.

    numpy equivalent of torchvision resized_crop as used by the RHD/HO3D
    pipelines (data/dataset.py:585, 1166); bilinear.
    """
    sx = width / res[1]
    sy = height / res[0]
    affine = np.linalg.inv(
        np.asarray([[sx, 0, left], [0, sy, top], [0, 0, 1.0]], np.float64)
    )
    return transform_img(img, affine, res, out_u8=out_u8)


def transform_img(img: np.ndarray, affine_trans: np.ndarray, res,
                  out_u8: bool = False) -> np.ndarray:
    """Bilinear warp with the crop transform -> float32 [0,1]-scale output,
    or rounded uint8 with `out_u8` (keeps augmented images uint8 end-to-end
    so the H2D transfer is 4x smaller; the train step normalises on device).

    uint8 input goes to the native C++ warp (csrc/imgwarp.cpp, which
    releases the GIL: the loaders' hot path); float input runs the numpy
    path below. Both take the same bilinear sample with zero padding outside
    the source.
    """
    if img.dtype == np.uint8:
        from hifihr_tpu_torch.data import native

        return native.warp_affine_one(img, affine_trans, res, out_u8=out_u8)
    inv = np.linalg.inv(affine_trans)
    h_out, w_out = res
    ys, xs = np.meshgrid(np.arange(h_out), np.arange(w_out), indexing="ij")
    coords = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], axis=0)
    src = inv @ coords
    sx, sy = src[0], src[1]

    h, w = img.shape[:2]
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    fx = sx - x0
    fy = sy - y0

    def sample(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yy_c = np.clip(yy, 0, h - 1)
        xx_c = np.clip(xx, 0, w - 1)
        vals = img[yy_c, xx_c].astype(np.float64)
        vals[~valid] = 0.0
        return vals

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    fx = fx[:, None] if img.ndim == 3 else fx
    fy = fy[:, None] if img.ndim == 3 else fy
    out = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    shape = (h_out, w_out) + (() if img.ndim == 2 else (img.shape[2],))
    warped = out.reshape(shape).astype(np.float32)
    if out_u8:
        return (warped * 255.0 + 0.5).astype(np.uint8)
    return warped


def color_jitter(
    img: np.ndarray,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
    hue: float = 0.0,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Random photometric jitter on a float [0, 1] HWC image.

    Port of the reference's utils/imgtrans.py color_jitter (factors drawn
    uniformly from [max(0, 1-x), 1+x], hue from [-hue, hue]; the reference's
    active dataset paths never call it, but the utility ships for parity).
    Brightness/contrast/saturation match torchvision.functional semantics;
    hue rotates in HSV space.
    """
    rng = rng or np.random
    out = img.astype(np.float32)
    if brightness > 0:
        out = out * rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        grey = out @ np.asarray([0.299, 0.587, 0.114], np.float32)
        out = grey[..., None] + f * (out - grey[..., None])
    if hue > 0:
        h = rng.uniform(-hue, hue)  # fraction of a full revolution
        maxc = out.max(-1)
        minc = out.min(-1)
        v = maxc
        delta = maxc - minc
        s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
        dz = np.maximum(delta, 1e-12)
        r, g, b = out[..., 0], out[..., 1], out[..., 2]
        hh = np.where(
            maxc == r, (g - b) / dz % 6.0,
            np.where(maxc == g, (b - r) / dz + 2.0, (r - g) / dz + 4.0),
        ) / 6.0
        hh = (hh + h) % 1.0
        i = np.floor(hh * 6.0)
        f = hh * 6.0 - i
        p = v * (1 - s)
        q = v * (1 - s * f)
        t = v * (1 - s * (1 - f))
        i = (i.astype(np.int32) % 6)[..., None]
        out = np.select(
            [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
            [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
             np.stack([p, v, t], -1), np.stack([p, q, v], -1),
             np.stack([t, p, v], -1), np.stack([v, p, q], -1)],
        )
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        mean = out.mean()
        out = mean + f * (out - mean)
    return np.clip(out, 0.0, 1.0)
