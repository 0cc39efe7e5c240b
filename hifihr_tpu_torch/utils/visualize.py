"""Visualisation dumps (counterpart of hifihr_tpu/utils/visualize.py): the
prediction grid, a minimal PNG writer and the 2D-error reports the Trainer
writes, and the demo's mesh OBJ (`save_obj`) and turntable
(`multiview_render`, through the port's renderer at 2 x 2 MSAA subsamples:
K1 and K2 on the card). Inputs are numpy arrays, NHWC; matplotlib is
imported at dump time only.
"""

from __future__ import annotations

import os

import numpy as np

from hifihr_tpu_torch.geometry.joints import FREI_BONES

_FINGER_COLORS = ["#777777", "#e41a1c", "#377eb8", "#4daf4a", "#984ea3", "#ff7f00"]


def plot_hand(ax, j2d: np.ndarray, linewidth: float = 1.5):
    """FreiHAND-order 21 keypoints onto a matplotlib axis."""
    for b, (pa, ch) in enumerate(FREI_BONES):
        color = _FINGER_COLORS[1 + b // 4]
        ax.plot([j2d[pa, 0], j2d[ch, 0]], [j2d[pa, 1], j2d[ch, 1]],
                color=color, linewidth=linewidth)
    ax.scatter(j2d[:, 0], j2d[:, 1], s=4, c="k", zorder=3)


def save_prediction_grid(path: str, examples: dict, outputs: dict, max_rows: int = 4):
    """Panel grid per sample: input / input+gt2d / input+pred2d / render / sil
    (the layout of the reference's displaydemo, visualize_util.py:640-691)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imgs = np.asarray(examples["imgs"])
    n = min(len(imgs), max_rows)
    cols = 2
    cols += 1 if "j2d" in outputs else 0
    cols += 1 if "re_img" in outputs else 0
    cols += 1 if "re_sil" in outputs else 0
    fig, axes = plt.subplots(n, cols, figsize=(2.2 * cols, 2.2 * n), squeeze=False)
    for r in range(n):
        c = 0
        axes[r][c].imshow(imgs[r]); axes[r][c].set_title("input"); c += 1
        axes[r][c].imshow(imgs[r])
        if "j2d_gt" in examples:
            plot_hand(axes[r][c], np.asarray(examples["j2d_gt"])[r])
        axes[r][c].set_title("gt 2d"); c += 1
        if "j2d" in outputs:
            axes[r][c].imshow(imgs[r])
            plot_hand(axes[r][c], np.asarray(outputs["j2d"])[r])
            axes[r][c].set_title("pred 2d"); c += 1
        if "re_img" in outputs:
            axes[r][c].imshow(np.clip(np.asarray(outputs["re_img"])[r], 0, 1))
            axes[r][c].set_title("render"); c += 1
        if "re_sil" in outputs:
            axes[r][c].imshow(np.asarray(outputs["re_sil"])[r, ..., 0], cmap="gray")
            axes[r][c].set_title("sil"); c += 1
        for ax in axes[r]:
            ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def write_png(path: str, img: np.ndarray) -> str:
    """Minimal RGB(A) PNG writer (zlib only).

    img: (H, W, 3|4) float in [0,1] or uint8.
    """
    import struct
    import zlib

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    h, w, c = img.shape
    color_type = 6 if c == 4 else 2
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
    return path


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray,
             vert_colors: np.ndarray | None = None,
             vert_uv: np.ndarray | None = None,
             texture_image: np.ndarray | None = None,
             face_uv: np.ndarray | None = None):
    """Write an OBJ: per-vertex colours, or a UV-textured mesh with MTL and
    PNG when (vert_uv or face_uv, texture_image) are given, the counterpart
    of the reference's save_textured_nimble (utils/visualize_util.py:16,27).

    `face_uv` (F, 3, 2) writes per-face-corner `vt` records (a seamed atlas:
    OBJ's f v/vt indexing with separate vt indices per corner). A texture
    image with more than 3 channels (NIMBLE's diffuse + normal + spec stack)
    exports the diffuse map to map_Kd, the normal map to <stem>_normal.png
    (map_Bump) and the specular weight to <stem>_spec.png (map_Ks)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    textured = (vert_uv is not None or face_uv is not None) and texture_image is not None
    stem = os.path.splitext(path)[0]
    with open(path, "w") as f:
        if textured:
            f.write(f"mtllib {os.path.basename(stem)}.mtl\n")
        for i, v in enumerate(np.asarray(verts)):
            if vert_colors is not None and not textured:
                c = np.asarray(vert_colors)[i]
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
            else:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if textured and face_uv is not None:
            fuv = np.asarray(face_uv).reshape(-1, 2)  # corner k of face i -> 3i + k
            for u, vv in fuv:
                f.write(f"vt {u:.6f} {1.0 - vv:.6f}\n")
            f.write("usemtl hand\n")
            for i, tri in enumerate(np.asarray(faces)):
                a, b, c = tri + 1
                f.write(f"f {a}/{3 * i + 1} {b}/{3 * i + 2} {c}/{3 * i + 3}\n")
        elif textured:
            for u, vv in np.asarray(vert_uv):
                # OBJ's vt origin is bottom-left, the sampler's top-left
                f.write(f"vt {u:.6f} {1.0 - vv:.6f}\n")
            f.write("usemtl hand\n")
            for tri in np.asarray(faces):
                a, b, c = tri + 1
                f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
        else:
            for tri in np.asarray(faces):
                f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")
    if textured:
        tex = np.asarray(texture_image)
        tex_path = write_png(stem + ".png", tex[..., :3])
        lines = ["newmtl hand", "Ka 1.0 1.0 1.0", "Kd 1.0 1.0 1.0", f"map_Kd {os.path.basename(tex_path)}"]
        if tex.shape[-1] >= 7:
            n_path = write_png(stem + "_normal.png", tex[..., 3:6])
            s_path = write_png(stem + "_spec.png", np.repeat(tex[..., 6:7], 3, axis=-1))
            lines += [f"map_Bump {os.path.basename(n_path)}", f"map_Ks {os.path.basename(s_path)}"]
        with open(stem + ".mtl", "w") as f:
            f.write("\n".join(lines) + "\n")
    return path


def multiview_render(verts: np.ndarray, faces, vert_colors, image_size: int = 224, n_views: int = 20,
                     distance: float = 0.5, device=None) -> np.ndarray:
    """Turntable renders around the hand (visualize_util.py:693-732): the
    mesh centred, turned by 2 pi k / n_views about the y axis and moved
    `distance` along z, one view at a time through the port's MSAA renderer
    at 2 x 2 subsamples,
    the faces in their given order (no Morton sort, as the JAX package's
    turntable renders them), default light, f = 1.8 image_size. Runs on
    the card unless `device` is 'cpu'. Returns (n_views, S, S, 4) numpy
    RGBA."""
    import torch

    from hifihr_tpu_torch import resolve_device
    from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings

    dev = resolve_device(device)
    renderer = PhongRenderer(np.asarray(faces), None, RenderSettings(image_size=image_size, aa_factor=2)).to(dev)
    f = image_size * 1.8
    K = torch.tensor([[[f, 0, image_size / 2], [0, f, image_size / 2], [0, 0, 1]]], dtype=torch.float32,
                     device=dev)
    colors = torch.as_tensor(np.asarray(vert_colors, np.float32)[None], device=dev)
    verts = np.asarray(verts)
    center = verts.mean(0)
    frames = []
    with torch.inference_mode():
        for k in range(n_views):
            theta = 2 * np.pi * k / n_views
            rot = np.asarray([[np.cos(theta), 0, np.sin(theta)], [0, 1, 0], [-np.sin(theta), 0, np.cos(theta)]],
                             np.float32)
            # in float64 after the offset, rounded to float32 once, as the JAX package's
            v = (verts - center) @ rot.T + np.asarray([0, 0, distance])
            rgba = renderer(torch.as_tensor(v[None], dtype=torch.float32, device=dev), colors, K)
            frames.append(rgba[0, ..., :4].cpu().numpy())
    return np.stack(frames)


def save_2d_errors(path_prefix: str, j2d_pred: np.ndarray, j2d_gt: np.ndarray) -> np.ndarray:
    """Per-sample mean 2D keypoint error dump and sorted error curve
    (reference utils/traineval_util.py:371-442 save_2d/save_2d_result)."""
    errs = np.linalg.norm(np.asarray(j2d_pred) - np.asarray(j2d_gt), axis=-1).mean(-1)
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    np.savetxt(path_prefix + "_2d_errors.txt", errs, fmt="%.4f")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(np.sort(errs))
    ax.set_xlabel("sample (sorted)")
    ax.set_ylabel("mean 2D error (px)")
    ax.set_title(f"mean={errs.mean():.2f}px  median={np.median(errs):.2f}px")
    fig.tight_layout()
    fig.savefig(path_prefix + "_2d_errors.png", dpi=110)
    plt.close(fig)
    return errs


def save_2d_error_report(save_dir: str, named_errors: dict) -> dict:
    """Per-epoch 2D-error artifacts matching the reference's save_2d_result
    (utils/traineval_util.py:371-426): per-sample-per-joint error txt per
    source ('proj' = reprojected model joints, 'pred' = heatmap branch,
    'detect' = openpose labels), plus one combined sorted-error-curve png.
    `named_errors[name]` is an (N, 21) array of pixel distances. Returns
    {name: overall mean error}."""
    os.makedirs(save_dir, exist_ok=True)
    means = {}
    for name, errs in named_errors.items():
        errs = np.asarray(errs)
        np.savetxt(os.path.join(save_dir, f"j2d_{name}_ED.txt"), errs, fmt="%.4f")
        means[name] = float(errs.mean())

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for name, errs in named_errors.items():
        per_sample = np.asarray(errs).mean(-1)
        ax.plot(np.sort(per_sample), label=f"{name} (mean {means[name]:.2f}px)")
    ax.set_xlabel("sample (sorted)")
    ax.set_ylabel("mean 2D error (px)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(
        save_dir,
        "error-" + "-".join(f"{k}_{v:.3f}" for k, v in means.items()) + ".png",
    ), dpi=110)
    plt.close(fig)
    return means
