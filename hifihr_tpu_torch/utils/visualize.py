"""Visualisation dumps the Trainer writes (counterpart of the parts of
hifihr_tpu/utils/visualize.py it calls): the prediction grid, a minimal PNG
writer and the 2D-error report. Inputs are numpy arrays, NHWC; matplotlib
is imported at dump time only.
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
