"""The loss stack (counterpart of hifihr_tpu/losses/stack.py::LossComputer).

Branches, by name (config.PORTED_LOSSES, every name the JAX package's stack
reads): joint_2d, joint_3d, vert_3d, bone_direc, bone_direc_3d,
edge_length, mscale, scale (FreiHand and RHD only), open_2dj, open_2dj_de
and open_bone_direc (when the batch carries `open_2dj`), joint_3d_norm,
kp_cons (when the model outputs `hm_j2d`, the rgb2hm branch), hm_integral
(with `open_2dj` in the batch) and hm_integral_gt (with `j2d_gt`), summed
over the heatmap stacks, tsa_poses (also listed as tsa_pose),
perceptual, sil, iou, triangle, mshape, mpose and mtex; and both
photometric triples by presence: texture_self, mrgb_self and ssim_tex_self
when the batch carries `texture_con`, texture, mrgb and ssim_tex when it
carries `segms_gt`. The reference's unit mix is kept: re_sil is in
{0, 255} and segms_gt in {0, 1}. Branches are summed into `total` in the
JAX package's order. A listed loss that did not fire warns once per
(names, dataset), decided in Python from the names alone.

Over several ranks (a parallel/mesh.py Mesh) every term is this rank's
share of the global term, the one the JAX package computes over the global
batch, so the shares sum over the ranks to it (the train step all-reduces
them for its report and its skip guard) and so do their gradients (the
optimizer sums the flat gradient). The ranks hold equal rows, so a mean
over this rank's rows divided by the world size is its share of the global
mean; that covers every term but five. The four ratio terms (open_2dj,
hm_integral, texture_self and mrgb_self) divide a sum over the rows by a
sum of squared confidences, which comes from the batch alone and is
all-reduced first (detached, one collective for all four); their share is
this rank's numerator over the global denominator. mrgb squares a
difference of global means, which is all-reduced with its gradient; like
the mean terms, each rank's share is 1/world of it.
"""

from __future__ import annotations

import warnings
from typing import Mapping

import torch
import torch.distributed

from hifihr_tpu_torch import constant
from hifihr_tpu_torch.assets import load_mano_model
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.losses import basic
from hifihr_tpu_torch.losses.perceptual import load_or_init_vgg, perceptual_loss
from hifihr_tpu_torch.losses.ssim import ssim
from hifihr_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from hifihr_tpu_torch.render.mesh import uniform_laplacian
from hifihr_tpu_torch.utils import profiling

REF_BONE_LENGTH = 0.0282  # metres, FreiHAND joints 9-10 prior (losses.py:297)
# open_2dj's per-keypoint weights: the wrist and the fingertips count more
OPEN_2DJ_WEIGHTS = (2, 1, 1, 1, 1.5, 1, 1, 1, 1.5, 1, 1, 1, 1.5, 1, 1, 1, 1.5, 1, 1, 1, 1.5)
# the terms whose value on a rank is already its share of the global term
SHARED_TERMS = ("open_2dj", "hm_integral", "texture_self", "mrgb_self")


def _mean_loss(base: str):
    if base == "L1":
        return lambda a, b: (a - b).abs().mean()
    return lambda a, b: ((a - b) ** 2).mean()


class LossComputer:
    """Built once per experiment. The `triangle` loss's MANO Laplacian and
    the `perceptual` loss's frozen VGG are built here, on the host, and move
    to the outputs' device on the first call that needs them."""

    def __init__(self, config: Config, mesh: Mesh | None = None):
        self.config = config
        self.mesh = mesh
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
        with profiling.span("loss", outputs) as sp:
            d = self._terms(examples, outputs, dat_name, sched)
            sp.outputs(d["total"])  # the terms leave the step detached
        return d

    def _terms(self, examples: Mapping[str, torch.Tensor], outputs: Mapping[str, torch.Tensor],
               dat_name: str, sched: Mapping[str, torch.Tensor] | None) -> dict:
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
        mesh = self.mesh if self.mesh is not None and self.mesh.distributed else None
        world = mesh.world if mesh is not None else 1
        rendered = "re_img" in outputs and "re_sil" in outputs
        den = self._denominators(examples, outputs, loss_used, rendered, mesh)
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
        if "open_2dj" in den:
            dist = basic.huber_2d_distance(examples["open_2dj"], outputs["j2d"])  # (B, 21)
            conf = examples["open_2dj_con"][..., 0] * constant(OPEN_2DJ_WEIGHTS, dist.device, dist.dtype)
            d["open_2dj"] = cfg.lambda_j2d * ((dist * conf**2).sum() / den["open_2dj"])
        if "open_2dj_de" in loss_used and "open_2dj" in examples:
            # the downgraded variant: plain MSE to the pseudo-labels (losses.py:58-63)
            d["open_2dj_de"] = cfg.lambda_j2d_de * ((examples["open_2dj"] - outputs["j2d"]) ** 2).mean()
        if "joint_3d_norm" in loss_used and "joints" in examples:
            # the joints relative to joint 9 (losses.py:71-74)
            po = outputs["joints"] - outputs["joints"][:, 9:10]
            pe = examples["joints"] - examples["joints"][:, 9:10]
            d["joint_3d_norm"] = cfg.lambda_j3d_norm * ((po - pe) ** 2).mean()
        if "open_bone_direc" in loss_used and "open_2dj" in examples:
            d["open_bone_direc"] = cfg.lambda_bone_direc * basic.bone_direction_loss(
                outputs["j2d"], examples["open_2dj"], examples["open_2dj_con"])
        if "kp_cons" in loss_used and "hm_j2d" in outputs:
            d["kp_cons"] = cfg.lambda_kp_cons * basic.huber_2d_distance(outputs["hm_j2d"], outputs["j2d"]).mean()
        # heatmap-integral supervision: each stack's soft-argmax uv against
        # the pseudo-labels or the ground truth (reference losses.py:14-44)
        if "hm_integral" in den:
            con2 = examples["open_2dj_con"][..., 0] ** 2
            acc = 0.0
            for hm_j2d in outputs["hm_j2d_list"]:
                dist = torch.sqrt(((examples["open_2dj"] - hm_j2d) ** 2).sum(-1) + 1e-12)
                acc = acc + (dist * con2).sum() / den["hm_integral"]
            d["hm_integral"] = cfg.lambda_hm * acc
        if "hm_integral_gt" in loss_used and "j2d_gt" in examples and "hm_j2d_list" in outputs:
            acc = 0.0
            for hm_j2d in outputs["hm_j2d_list"]:
                acc = acc + torch.sqrt(((examples["j2d_gt"] - hm_j2d) ** 2).sum(-1) + 1e-12).mean()
            d["hm_integral_gt"] = cfg.lambda_hm * acc
        if ("tsa_poses" in loss_used or "tsa_pose" in loss_used) and "tsa_poses" in outputs:
            d["tsa_poses"] = lam_pose * basic.tsa_pose_loss(outputs["tsa_poses"])

        # photometric, self-supervised (confidence-weighted)
        if rendered and "texture_con" in examples:
            re_img = outputs["re_img"]
            mask_rgbs = outputs["maskRGBs"]
            con = examples["texture_con"]  # (B,)
            con_img = con[:, None, None, None] ** 2
            d["texture_self"] = cfg.lambda_texture * (
                ((re_img - mask_rgbs).abs() * con_img).sum() / den["texture_self"])
            b = re_img.shape[0]
            mean_diff = (re_img.reshape(b, -1).mean(1) - mask_rgbs.reshape(b, -1).mean(1)).abs()
            d["mrgb_self"] = cfg.lambda_mrgb * ((mean_diff * con**2).sum() / den["mrgb_self"])
            # re_img is the render's first three channels, a strided view: K5
            # takes NHWC contiguous images
            d["ssim_tex_self"] = cfg.lambda_ssim_tex * (1.0 - ssim(re_img.contiguous(), mask_rgbs))
        # photometric, fully supervised against the ground-truth mask
        if rendered and "segms_gt" in examples:
            gt_masked = examples["segms_gt"][..., None] * examples["imgs"]
            re_img = outputs["re_img"] * (outputs["re_sil"] / 255.0)
            d["texture"] = cfg.lambda_texture * (re_img - gt_masked).abs().mean()
            diff = gt_masked.mean() - re_img.mean()
            if mesh is not None:
                diff = all_reduce_sum(diff / world, mesh.group)
            d["mrgb"] = cfg.lambda_mrgb * diff ** 2
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
        if world > 1:
            d = {k: v if k in SHARED_TERMS else v / world for k, v in d.items()}
        d["total"] = sum(d.values()) if d else outputs["joints"].new_zeros(())
        return d

    def _denominators(self, examples: Mapping[str, torch.Tensor], outputs: Mapping[str, torch.Tensor],
                      loss_used: tuple, rendered: bool, mesh: Mesh | None) -> dict:
        """The ratio terms' denominators, sums of squared confidences over
        the global batch (over `mesh`'s ranks in one detached all-reduce),
        each clamped at 1e-8 as the JAX package does; only those of the
        terms that fire."""
        sums = {}
        if "open_2dj" in loss_used and "open_2dj" in examples:
            con = examples["open_2dj_con"][..., 0]
            sums["open_2dj"] = ((con * constant(OPEN_2DJ_WEIGHTS, con.device, con.dtype)) ** 2).sum()
        if "hm_integral" in loss_used and "open_2dj" in examples and "hm_j2d_list" in outputs:
            sums["hm_integral"] = (examples["open_2dj_con"][..., 0] ** 2).sum()
        if rendered and "texture_con" in examples:
            con = examples["texture_con"]
            sums["texture_self"] = (con[:, None, None, None] ** 2).expand_as(outputs["re_img"]).sum()
            sums["mrgb_self"] = (con**2).sum()
        if not sums:
            return {}
        if mesh is not None:
            total = torch.stack(list(sums.values())).detach()
            torch.distributed.all_reduce(total, group=mesh.group)
            sums = dict(zip(sums, total.unbind()))
        return {k: v.clamp(min=1e-8) for k, v in sums.items()}

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
                          stacklevel=4)
