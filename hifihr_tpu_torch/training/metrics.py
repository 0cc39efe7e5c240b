"""Evaluation metrics (counterpart of hifihr_tpu/training/metrics.py):
Procrustes alignment and PA-MPJPE, batched on the device; PCK/AUC/EPE in
numpy; the masked texture metrics of the rendered image.

References: utils/train_utils.py:267-290 (align_w_scale), utils/fh_utils.py:
719-815 (EvalUtil), train_hrnet.py:148-161 and compute_texture_metric.py
(masked PSNR/SSIM/L1/L2, LPIPS).
"""

from __future__ import annotations

import numpy as np
import torch

from hifihr_tpu_torch.losses.ssim import ssim as ssim_metric


def align_w_scale(mtx1: torch.Tensor, mtx2: torch.Tensor) -> torch.Tensor:
    """Procrustes-align mtx2 to mtx1, both (B, N, 3): rotation, scale and
    translation per item; returns the aligned mtx2. As in the JAX package
    there is no reflection fix. The batched 3x3 SVD may sync the host on the
    card; it runs once per eval epoch."""
    t1 = mtx1.mean(1, keepdim=True)
    t2 = mtx2.mean(1, keepdim=True)
    x1 = mtx1 - t1
    x2 = mtx2 - t2
    n1 = x1.square().sum((1, 2), keepdim=True).sqrt()
    n2 = x2.square().sum((1, 2), keepdim=True).sqrt()
    x1 = x1 / n1
    x2 = x2 / n2
    # orthogonal procrustes
    u, w, vt = torch.linalg.svd(x2.transpose(1, 2) @ x1)
    r = (u @ vt).transpose(1, 2)
    s = w.sum(-1)[:, None, None] * n1 / n2
    return (mtx2 - t2) @ r.transpose(1, 2) * s + t1


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned mean per-joint error, metres. (B, N, 3) each."""
    aligned = align_w_scale(gt, pred)
    return torch.linalg.norm(aligned - gt, dim=-1).mean()


class EvalUtil:
    """Accumulates per-joint 3D errors; yields EPE mean/median, PCK AUC."""

    def __init__(self, num_kp: int = 21):
        self.errors = [[] for _ in range(num_kp)]

    def feed(self, kp_gt, kp_pred, vis=None):
        kp_gt = np.asarray(kp_gt)
        kp_pred = np.asarray(kp_pred)
        if kp_gt.ndim == 3:  # batched
            for g, p in zip(kp_gt, kp_pred):
                self.feed(g, p)
            return
        dist = np.linalg.norm(kp_gt - kp_pred, axis=-1)
        for i, d in enumerate(dist):
            if vis is None or vis[i]:
                self.errors[i].append(float(d))

    def _pck(self, kp_id: int, threshold: float) -> float:
        e = np.asarray(self.errors[kp_id])
        return float(np.mean(e <= threshold)) if e.size else np.nan

    def get_measures(self, val_min=0.0, val_max=0.05, steps=100):
        """Returns (epe_mean, epe_median, auc, pck_curve, thresholds)."""
        epe_all = np.concatenate([np.asarray(e) for e in self.errors if len(e)])
        thresholds = np.linspace(val_min, val_max, steps)
        pck_curve = []
        aucs = []
        norm = np.trapezoid(np.ones_like(thresholds), thresholds)
        for kp in range(len(self.errors)):
            if not self.errors[kp]:
                continue
            pck = np.asarray([self._pck(kp, t) for t in thresholds])
            pck_curve.append(pck)
            aucs.append(np.trapezoid(pck, thresholds) / norm)
        pck_curve = np.mean(np.stack(pck_curve), 0) if pck_curve else np.zeros_like(thresholds)
        return (
            float(np.mean(epe_all)),
            float(np.median(epe_all)),
            float(np.mean(aucs)) if aucs else np.nan,
            pck_curve,
            thresholds,
        )


def texture_metrics(re_img, re_sil, real_img, gt_mask=None, lpips=None) -> dict:
    """Masked PSNR / SSIM / L1 / L2 / LPIPS between the render and the real
    image, as device scalars. re_img, real_img (B, H, W, 3); re_sil
    (B, H, W, 1) in {0, 255} or {0, 1}; gt_mask (B, H, W). LPIPS runs when
    an `lpips` module is given and the images are 64 px or more (AlexNet's
    stride-4 conv and pools); its key is 'lpips_randinit' for random
    features, as in the JAX package."""
    if real_img.dtype == torch.uint8:
        real_img = real_img.float() / 255.0
    if gt_mask is not None and gt_mask.dtype == torch.uint8:
        gt_mask = gt_mask.float()
    sil = (re_sil > 0).to(re_img.dtype)
    pred = re_img * sil
    gt = real_img * (gt_mask[..., None] if gt_mask is not None else sil)
    mse = (pred - gt).square().mean()
    out = {
        "psnr": -10.0 * torch.log10(mse.clamp_min(1e-12)),
        "ssim": ssim_metric(pred, gt),
        "l1": (pred - gt).abs().mean(),
        "l2": mse,
    }
    if lpips is not None and re_img.shape[1] >= 64:
        key = "lpips" if lpips.pretrained else "lpips_randinit"
        out[key] = lpips(pred * 2.0 - 1.0, gt * 2.0 - 1.0).mean()
    return out
