"""The loss stack (counterpart of hifihr_tpu/losses/stack.py::LossComputer).

Ported branches, by name (config.PORTED_LOSSES; Config raises on any other):
joint_2d, joint_3d, vert_3d, bone_direc, bone_direc_3d, edge_length,
mscale, scale (FreiHand and RHD only), open_2dj and open_bone_direc (when
the batch carries `open_2dj`), tsa_poses (also listed as tsa_pose),
perceptual, sil, iou, triangle, mshape, mpose and mtex; and both
photometric triples by presence: texture_self, mrgb_self and ssim_tex_self
when the batch carries `texture_con`, texture, mrgb and ssim_tex when it
carries `segms_gt`. The reference's unit mix is kept: re_sil is in
{0, 255} and segms_gt in {0, 1}. Branches are summed into `total` in the
JAX package's order. A listed loss that did not fire warns once per
(names, dataset), decided in Python from the names alone.
"""

from __future__ import annotations

import warnings
from typing import Mapping

import torch

from hifihr_tpu_torch import constant
from hifihr_tpu_torch.assets import load_mano_model
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.losses import basic
from hifihr_tpu_torch.losses.perceptual import load_or_init_vgg, perceptual_loss
from hifihr_tpu_torch.losses.ssim import ssim
from hifihr_tpu_torch.render.mesh import uniform_laplacian

REF_BONE_LENGTH = 0.0282  # metres, FreiHAND joints 9-10 prior (losses.py:297)
# open_2dj's per-keypoint weights: the wrist and the fingertips count more
OPEN_2DJ_WEIGHTS = (2, 1, 1, 1, 1.5, 1, 1, 1, 1.5, 1, 1, 1, 1.5, 1, 1, 1, 1.5, 1, 1, 1, 1.5)


def _mean_loss(base: str):
    if base == "L1":
        return lambda a, b: (a - b).abs().mean()
    return lambda a, b: ((a - b) ** 2).mean()


class LossComputer:
    """Built once per experiment. The `triangle` loss's MANO Laplacian and
    the `perceptual` loss's frozen VGG are built here, on the host, and move
    to the outputs' device on the first call that needs them."""

    def __init__(self, config: Config):
        self.config = config
        self.base_loss = _mean_loss(config.base_loss_fn)
        all_used = set(config.losses) | set(config.losses_frei) | set(config.losses_rhd)
        self.laplacian = None
        if "triangle" in all_used:
            faces = load_mano_model().faces
            self.laplacian = uniform_laplacian(int(faces.max()) + 1, faces)
        # only `losses` builds it, as in the JAX package: perceptual listed in
        # losses_frei or losses_rhd alone does not fire, and warns
        self.vgg = load_or_init_vgg() if "perceptual" in config.losses else None
        self._warned_unfired = set()

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
        lam_tex_reg = sched.get("lambda_tex_reg", cfg.lambda_at_epoch("tex_reg", 0))
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
        if "bone_direc_3d" in loss_used:
            conf = torch.ones_like(examples["joints"][..., :1])
            d["bone_direc_3d"] = cfg.lambda_bone_direc_3d * basic.bone_direction_loss(
                outputs["joints"], examples["joints"], conf)
        if "edge_length" in loss_used:
            d["edge_length"] = cfg.lambda_edge_len * basic.edge_length_loss(
                outputs["mano_verts"], examples["verts"], outputs["mano_faces"])
        if "mscale" in loss_used:
            joints = outputs["joints"]
            bone = torch.linalg.vector_norm(joints[:, 9] - joints[:, 10], dim=-1)
            d["mscale"] = cfg.lambda_mscale * (bone - REF_BONE_LENGTH).abs().mean()
        if "scale" in loss_used and dat_name in ("FreiHand", "RHD"):
            joints = outputs["joints"]
            cal = torch.linalg.vector_norm(joints[:, 9] - joints[:, 10], dim=-1)
            d["scale"] = cfg.lambda_scale * ((cal - examples["scales"]) ** 2).mean()

        # weak supervision against openpose pseudo-labels
        if "open_2dj" in loss_used and "open_2dj" in examples:
            dist = basic.huber_2d_distance(examples["open_2dj"], outputs["j2d"])  # (B, 21)
            conf = examples["open_2dj_con"][..., 0] * constant(OPEN_2DJ_WEIGHTS, dist.device, dist.dtype)
            d["open_2dj"] = cfg.lambda_j2d * ((dist * conf**2).sum() / (conf**2).sum().clamp(min=1e-8))
        if "open_bone_direc" in loss_used and "open_2dj" in examples:
            d["open_bone_direc"] = cfg.lambda_bone_direc * basic.bone_direction_loss(
                outputs["j2d"], examples["open_2dj"], examples["open_2dj_con"])
        if ("tsa_poses" in loss_used or "tsa_pose" in loss_used) and "tsa_poses" in outputs:
            d["tsa_poses"] = lam_pose * basic.tsa_pose_loss(outputs["tsa_poses"])

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

        if "perceptual" in loss_used and self.vgg is not None:
            seg = examples["segms_gt"][..., None]
            composite = outputs["re_img"] * seg + examples["imgs"] * (1.0 - seg)
            d["perceptual"] = cfg.lambda_percep * perceptual_loss(
                self.vgg.to(composite.device), composite, examples["imgs"])
        if "sil" in loss_used:
            d["sil"] = cfg.lambda_silhouette * (
                outputs["re_sil"][..., 0] - examples["segms_gt"]).abs().mean()
        if "iou" in loss_used:
            d["iou"] = cfg.lambda_iou * basic.iou_loss(outputs["re_sil"][..., 0], examples["segms_gt"])
        if "triangle" in loss_used and self.laplacian is not None:
            verts = outputs["mano_verts"]
            if self.laplacian.device != verts.device:
                self.laplacian = self.laplacian.to(verts.device)
            d["triangle"] = cfg.lambda_laplacian * basic.laplacian_loss(verts, self.laplacian)
        if "mshape" in loss_used:
            d["mshape"] = lam_shape * (outputs["shape_params"] ** 2).mean()
        if "mpose" in loss_used:
            d["mpose"] = lam_pose * (outputs["pose_params"] ** 2).mean()
        if "mtex" in loss_used and outputs.get("texture_params") is not None:
            d["mtex"] = lam_tex_reg * (outputs["texture_params"] ** 2).mean()

        self._warn_unfired(loss_used, d, dat_name)
        d["total"] = sum(d.values()) if d else outputs["joints"].new_zeros(())
        return d

    def _warn_unfired(self, loss_used: tuple, d: dict, dat_name: str) -> None:
        """Warn once per (names, dataset) about listed losses that did not
        fire: a missing model output or batch key (the reference asserts
        these preconditions). scale is expected not to fire off FreiHand and
        RHD, and tsa_pose fires as tsa_poses."""
        expected = {"scale"} if dat_name not in ("FreiHand", "RHD") else set()
        unfired = [n for n in loss_used if n not in d and n != "tsa_pose" and n not in expected]
        key = (tuple(unfired), dat_name)
        if unfired and key not in self._warned_unfired:
            self._warned_unfired.add(key)
            warnings.warn(f"configured losses {unfired} did not fire for dataset {dat_name}: missing model "
                          f"outputs or batch keys (reference asserts these preconditions, losses.py:246)",
                          stacklevel=3)
