"""The loss stack, with the branches the flagship train step fires
(counterpart of hifihr_tpu/losses/stack.py::LossComputer).

Ported branches: joint_2d, joint_3d, vert_3d, bone_direc, mscale, sil, iou,
mshape and mpose by name (config.PORTED_LOSSES; Config raises on any other),
and both photometric triples by presence: texture_self, mrgb_self and
ssim_tex_self when the batch carries `texture_con`, texture, mrgb and
ssim_tex when it carries `segms_gt`. The reference's unit mix is kept:
re_sil is in {0, 255} and segms_gt in {0, 1}. Branches are summed into
`total` in the JAX package's order.
"""

from __future__ import annotations

from typing import Mapping

import torch

from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.losses import basic
from hifihr_tpu_torch.losses.ssim import ssim

REF_BONE_LENGTH = 0.0282  # metres, FreiHAND joints 9-10 prior (losses.py:297)


def _mean_loss(base: str):
    if base == "L1":
        return lambda a, b: (a - b).abs().mean()
    return lambda a, b: ((a - b) ** 2).mean()


class LossComputer:
    def __init__(self, config: Config):
        self.config = config
        self.base_loss = _mean_loss(config.base_loss_fn)

    def __call__(self, examples: Mapping[str, torch.Tensor], outputs: Mapping[str, torch.Tensor],
                 dat_name: str, sched: Mapping[str, torch.Tensor] | None = None) -> dict:
        cfg = self.config
        if dat_name == "FreiHand" and cfg.losses_frei:
            loss_used = cfg.losses_frei
        elif dat_name == "RHD" and cfg.losses_rhd:
            loss_used = cfg.losses_rhd
        else:
            loss_used = cfg.losses
        sched = sched or {}
        lam_j2d_gt = sched.get("lambda_j2d_gt", cfg.lambda_at_epoch("j2d_gt", 0))
        lam_shape = sched.get("lambda_shape", cfg.lambda_at_epoch("shape", 0))
        lam_pose = sched.get("lambda_pose", cfg.lambda_at_epoch("pose", 0))
        base = self.base_loss
        d = {}

        if "joint_2d" in loss_used:
            d["joint_2d"] = lam_j2d_gt * base(examples["j2d_gt"], outputs["j2d"])
        if "joint_3d" in loss_used:
            d["joint_3d"] = cfg.lambda_j3d * base(outputs["joints"], examples["joints"])
        if "vert_3d" in loss_used:
            d["vert_3d"] = cfg.lambda_vert_3d * base(outputs["mano_verts"], examples["verts"])
        if "bone_direc" in loss_used:
            conf = torch.ones_like(examples["j2d_gt"][..., :1])
            d["bone_direc"] = cfg.lambda_bone_direc * basic.bone_direction_loss(
                outputs["j2d"], examples["j2d_gt"], conf)
        if "mscale" in loss_used:
            joints = outputs["joints"]
            bone = torch.linalg.vector_norm(joints[:, 9] - joints[:, 10], dim=-1)
            d["mscale"] = cfg.lambda_mscale * (bone - REF_BONE_LENGTH).abs().mean()

        rendered = "re_img" in outputs and "re_sil" in outputs
        # photometric, self-supervised (confidence-weighted)
        if rendered and "texture_con" in examples:
            re_img = outputs["re_img"]
            mask_rgbs = outputs["maskRGBs"]
            con = examples["texture_con"]  # (B,)
            con_img = con[:, None, None, None] ** 2
            d["texture_self"] = cfg.lambda_texture * (
                ((re_img - mask_rgbs).abs() * con_img).sum()
                / con_img.expand_as(re_img).sum().clamp(min=1e-8))
            b = re_img.shape[0]
            mean_diff = (re_img.reshape(b, -1).mean(1) - mask_rgbs.reshape(b, -1).mean(1)).abs()
            d["mrgb_self"] = cfg.lambda_mrgb * (
                (mean_diff * con**2).sum() / (con**2).sum().clamp(min=1e-8))
            d["ssim_tex_self"] = cfg.lambda_ssim_tex * (1.0 - ssim(re_img, mask_rgbs))
        # photometric, fully supervised against the ground-truth mask
        if rendered and "segms_gt" in examples:
            gt_masked = examples["segms_gt"][..., None] * examples["imgs"]
            re_img = outputs["re_img"] * (outputs["re_sil"] / 255.0)
            d["texture"] = cfg.lambda_texture * (re_img - gt_masked).abs().mean()
            d["mrgb"] = cfg.lambda_mrgb * (gt_masked.mean() - re_img.mean()) ** 2
            d["ssim_tex"] = cfg.lambda_ssim_tex * (1.0 - ssim(re_img, gt_masked))

        if "sil" in loss_used:
            d["sil"] = cfg.lambda_silhouette * (
                outputs["re_sil"][..., 0] - examples["segms_gt"]).abs().mean()
        if "iou" in loss_used:
            d["iou"] = cfg.lambda_iou * basic.iou_loss(outputs["re_sil"][..., 0], examples["segms_gt"])
        if "mshape" in loss_used:
            d["mshape"] = lam_shape * (outputs["shape_params"] ** 2).mean()
        if "mpose" in loss_used:
            d["mpose"] = lam_pose * (outputs["pose_params"] ** 2).mean()

        d["total"] = sum(d.values()) if d else outputs["joints"].new_zeros(())
        return d
