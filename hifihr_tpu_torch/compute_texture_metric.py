"""Offline texture metrics over saved render/real image pairs (counterpart
of the root compute_texture_metric.py, the reference's
compute_texture_metric.py):

    python -m hifihr_tpu_torch.compute_texture_metric --image_path <dir> [--center_crop]
        [--device cuda|cpu]

It walks a directory of `*_raw_img.png` / `*_re_img.png` / `*_re_sil.png`
triples, computes the masked PSNR, SSIM, L1 and L2
(training/metrics.py::texture_metrics) and LPIPS (losses/lpips.py) of each,
and prints their means. `--center_crop` cuts large renders to their
central 224^2 (reference :37-39). It runs on the card unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

METRICS = ("psnr", "ssim", "l1", "l2", "lpips")


def center_crop(img: np.ndarray, size: int = 224) -> np.ndarray:
    h, w = img.shape[:2]
    y0 = (h - size) // 2
    x0 = (w - size) // 2
    return img[y0:y0 + size, x0:x0 + size]


def main(argv=None) -> dict:
    """Prints each metric's mean and count; returns {metric: mean}."""
    import torch

    from hifihr_tpu_torch import resolve_device
    from hifihr_tpu_torch.data.freihand import _load_image
    from hifihr_tpu_torch.losses.lpips import LPIPS
    from hifihr_tpu_torch.training.metrics import texture_metrics

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image_path", required=True)
    parser.add_argument("--center_crop", action="store_true")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    lpips_fn = LPIPS().to(device)
    if not lpips_fn.pretrained:
        print("WARNING: assets/lpips_alex.npz absent; LPIPS uses random features")
    names = sorted(f[:-len("_raw_img.png")] for f in os.listdir(args.image_path) if f.endswith("_raw_img.png"))
    acc = {k: [] for k in METRICS}
    with torch.inference_mode():
        for name in names:
            raw, re, sil = (_load_image(os.path.join(args.image_path, f"{name}_{kind}.png"))
                            for kind in ("raw_img", "re_img", "re_sil"))
            if sil.ndim == 3:
                sil = sil[..., 0]
            if args.center_crop:
                raw, re, sil = center_crop(raw), center_crop(re), center_crop(sil)
            raw_t, re_t, sil_t = (torch.as_tensor(np.asarray(a, np.float32)[None], device=device)
                                  for a in (raw, re, sil))
            m = texture_metrics(re_t, sil_t[..., None], raw_t)
            mask = (sil_t > 0)[..., None].to(re_t.dtype)
            d = lpips_fn((re_t * mask) * 2 - 1, (raw_t * mask) * 2 - 1)
            for k in METRICS[:4]:
                acc[k].append(float(m[k]))
            acc["lpips"].append(float(d[0]))
    means = {}
    for k, v in acc.items():
        means[k] = float(np.mean(v))
        print(f"{k}: {means[k]:.5f} (n={len(v)})")
    return means


if __name__ == "__main__":
    main()
