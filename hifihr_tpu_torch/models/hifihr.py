"""Composite hand reconstruction model, MANO, NIMBLE and mano_new branches
(counterpart of hifihr_tpu/models/hifihr.py::HiFiHR and attach_j2d).

encoder (ResNet, EfficientNet-b3 or HRNet-W18-small-v2) -> light estimator
(none for HRNet, which has no low-level tap) -> hand parameter heads -> MANO or NIMBLE ->
root-centering -> MSAA or SSAA render (`config.aa_mode`). NIMBLE's MSAA
render samples its PCA appearance at the face corners
(`nimble_corner_tex`) or its UV maps per fragment; its SSAA render always
samples the UV maps. Outputs keep the JAX keys and layouts: images NHWC,
re_img (B, S, S, 3), re_sil (B, S, S, 1) in {0, 255}, re_depth (B, S, S),
maskRGBs. The encoder runs in `config.compute_dtype` (bf16 autocast on the
card); everything after it runs in fp32. With `rgb2hm` the stacked-hourglass
branch (networks/hourglass.py) reads the raw images in fp32 and outputs each
stack's soft-argmax joints in image pixels (`hm_j2d_list`) and the last
stack's (`hm_j2d`).

`hand_model="mano_new"` is the YTBHand baseline: ResNet-50 in fp32 (the JAX
package builds that encoder without a dtype), two MLP heads for MANO's
shape (10) and pose (48), MANO, and the FreiHAND joints regressed from the
mesh; no light estimator and no render.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as Fn
from torch import nn

from hifihr_tpu_torch import constant, variance_scaling_
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.geometry.joints import MANO_TO_FREI, remap
from hifihr_tpu_torch.geometry.projection import orthographic_project, perspective_project
from hifihr_tpu_torch.hand.mano import ManoLayer, regress_joints_frei
from hifihr_tpu_torch.hand.nimble import NimbleLayer
from hifihr_tpu_torch.networks.efficientnet import EffNetEncoder
from hifihr_tpu_torch.networks.heads import HandEncoder, LightEstimator
from hifihr_tpu_torch.networks.hourglass import NetHMHG, heatmaps_to_uv
from hifihr_tpu_torch.networks.hrnet import HRNetEncoder
from hifihr_tpu_torch.networks.resnet import ResNetEncoder, StemConv
from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings
from hifihr_tpu_torch.render.shading import DirectionalLight
from hifihr_tpu_torch.utils import profiling

ROOT_ID = 9  # FreiHAND middle-MCP root
ROOT_ID_NIMBLE = 11  # NIMBLE's 25-joint root


class HiFiHR(nn.Module):
    """Parameter names follow the flax tree (`encoder.backbone.layer1_0...`,
    `encoder.backbone.block3.se_reduce`, `hand_encoder.base_fc0`,
    `light_estimator.conv1`, `vert_tex` for MANO),
    so `hifihr_tpu_torch.convert.state_dict_from_flax` maps them one to
    one."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        cin = 4 if config.four_channel else 3  # the heatmap channel rides the images
        if config.hand_model == "mano_new":
            # whatever config.pretrain says (JAX hifihr.py:47-55)
            self.encoder = ResNetEncoder("res50", cin)
            feat = self.encoder.backbone.out_channels
            self.beta_fc0, self.beta_fc1 = nn.Linear(feat, 512), nn.Linear(512, 10)
            self.theta_fc0, self.theta_fc1 = nn.Linear(feat, 512), nn.Linear(512, 48)
            self.mano = ManoLayer(ncomps=45)
            return
        if config.pretrain in ("res18", "res50", "res101"):
            self.encoder = ResNetEncoder(config.pretrain, cin)
        elif config.pretrain == "effb3":
            self.encoder = EffNetEncoder(cin=cin)
        elif config.pretrain == "hr18sv2":
            self.encoder = HRNetEncoder(cin)
        else:  # "none": the Config takes it and the model refuses it, as JAX's does
            raise ValueError(config.pretrain)
        backbone = self.encoder.backbone
        shape_nc, pose_nc, tex_nc = config.ncomps
        self.hand_encoder = HandEncoder(backbone.out_channels, shape_nc, pose_nc,
                                        config.use_mean_shape, config.hand_model, tex_nc, config.render)
        # HRNet has no low-level tap: JAX never calls its light estimator, so
        # flax creates no parameters for it, and neither does the port
        if config.light_estimation and backbone.low_channels is not None:
            self.light_estimator = LightEstimator(backbone.low_channels)
        if config.rgb2hm:  # reference rgb2hm (utils/train_utils.py:104-111)
            self.rgb2hm = NetHMHG(config.image_size, cin=cin)
        settings = RenderSettings(image_size=config.image_size, aa_factor=config.aa_factor,
                                  aa_mode=config.aa_mode)
        if config.hand_model == "mano":
            self.mano = ManoLayer(ncomps=pose_nc - 3)
            if config.render:
                self.vert_tex = nn.Parameter(torch.zeros(778, 3))
                self.renderer = PhongRenderer(self.mano.faces_np, self.mano.v_template_np, settings)
        else:
            self.nimble = NimbleLayer()
            self.mano = ManoLayer()  # supplies mano_faces only
            if config.render:
                # the UV tables where the asset has a chart (JAX hifihr.py:217-220);
                # the corner tables for the MSAA corner path only
                nb, uv = self.nimble, self.nimble.vert_uv_np is not None
                corner = config.nimble_corner_tex
                self.renderer = PhongRenderer(nb.faces_np, nb.v_template_np, settings,
                                              vert_uv=nb.vert_uv_np, face_uv=nb.face_uv_np if uv else None,
                                              corner_mean=nb.corner_mean_np if corner else None,
                                              corner_basis=nb.corner_basis_np if corner else None)

    def _encoder_autocast(self, device: torch.device):
        if self.config.compute_dtype == "bfloat16":
            return torch.autocast(device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def _vertex_albedo(self, batch: int) -> torch.Tensor:
        skin = constant([1.0, 0.2, -0.2], self.vert_tex.device, self.vert_tex.dtype)
        return torch.sigmoid(self.vert_tex + skin)[None].expand(batch, 778, 3)

    def forward(self, images: torch.Tensor, Ks: torch.Tensor | None = None,
                root_xyz: torch.Tensor | None = None, dat_name: str = "FreiHand",
                mode_train: bool = True) -> dict:
        """images (B, S, S, 3) float in [0, 1] (4 channels with the heatmap
        under `four_channel`); Ks (B, 3, 3); root_xyz (B, 1, 3)."""
        cfg = self.config
        if cfg.hand_model == "mano_new":
            return self._forward_mano_new(images)
        b = images.shape[0]
        with profiling.span("encoder") as sp:
            with self._encoder_autocast(images.device):
                low, features = self.encoder(images)
            light_params = None
            if cfg.light_estimation and low is not None:
                light_params = self.light_estimator(low.float())
            hand_params = self.hand_encoder(features)
            hm_uv = None
            if cfg.rgb2hm:
                # each stack's soft-argmax uv at heatmap resolution, scaled to
                # image pixels (compute_uv_from_integral, visualize_util.py:859-880)
                hms = self.rgb2hm(images)
                hm_scale = images.shape[1] / hms[-1].shape[1]
                hm_uv = tuple(heatmaps_to_uv(h) * hm_scale for h in hms)
            sp.outputs(hand_params, light_params, hm_uv)
        outputs = dict(hand_params)
        if hm_uv is not None:
            outputs["hm_j2d_list"] = hm_uv
            outputs["hm_j2d"] = hm_uv[-1]
        ho3d_eval = dat_name == "HO3D" and not mode_train
        with profiling.span("hand", hand_params) as sp:
            if cfg.hand_model == "mano":
                mano_out = self.mano(hand_params["pose_params"], hand_params["shape_params"])
                verts = mano_out.verts
                joints = regress_joints_frei(verts, self.mano.J_regressor)
                outputs["tsa_poses"] = mano_out.full_pose
            else:
                outputs.update(self.nimble(hand_params))
                joints = remap(outputs["joints"], MANO_TO_FREI)  # legacy MANO order -> FreiHAND
                verts = outputs["mano_verts"]

            pred_root = joints[:, 0:1] if ho3d_eval else joints[:, ROOT_ID:ROOT_ID + 1]
            outputs["joints"] = joints - pred_root
            outputs["mano_verts"] = verts - pred_root
            if cfg.hand_model == "nimble":
                nj = outputs["nimble_joints"]
                nroot = nj[:, 0:1] if ho3d_eval else nj[:, ROOT_ID_NIMBLE:ROOT_ID_NIMBLE + 1]
                outputs["nimble_joints"] = nj - nroot
            sp.outputs(outputs)

        if cfg.render and Ks is not None and root_xyz is not None:
            with profiling.span("renderer", (outputs, light_params)) as sp:
                texture_image = None
                if cfg.hand_model == "mano":
                    render_verts, albedo, tex_coef = outputs["mano_verts"] + root_xyz, self._vertex_albedo(b), None
                else:  # offset by the NIMBLE root
                    render_verts = outputs["skin_verts"] - nroot + root_xyz
                    albedo, tex_coef = outputs["skin_albedo"], hand_params["texture_params"]
                    if self.nimble.vert_uv_np is not None:
                        texture_image = outputs["textures"]
                if light_params is not None:
                    light = DirectionalLight.from_estimator(light_params["colors"],
                                                            light_params["directions"])
                else:
                    light = DirectionalLight.default(b, images.dtype, images.device)
                rgba = self.renderer(render_verts, albedo, Ks[:, :3, :3], light, tex_coef=tex_coef,
                                     texture_image=texture_image)
                re_sil = (rgba[..., 3:4] > 0).to(images.dtype) * 255.0
                outputs["re_img"] = rgba[..., :3]
                outputs["re_sil"] = re_sil
                outputs["re_depth"] = rgba[..., 4]
                outputs["maskRGBs"] = images * (re_sil > 0).to(images.dtype)
                sp.outputs(outputs["re_img"], outputs["re_depth"], outputs["maskRGBs"])

        outputs["mano_faces"] = self.mano.faces
        if light_params is not None:
            outputs["light_params"] = light_params
        return outputs

    def _forward_mano_new(self, images: torch.Tensor) -> dict:
        """JAX hifihr.py:118-140: the encoder in fp32 (no autocast), the two
        heads, MANO, joints centred on root 9."""
        _, feat = self.encoder(images)
        beta = self.beta_fc1(Fn.relu(self.beta_fc0(feat)))
        if self.config.use_mean_shape:
            beta = torch.zeros_like(beta)
        theta = self.theta_fc1(Fn.relu(self.theta_fc0(feat)))
        verts = self.mano(theta, beta).verts
        joints = regress_joints_frei(verts, self.mano.J_regressor)
        root = joints[:, ROOT_ID:ROOT_ID + 1]
        return {"pose_params": theta, "shape_params": beta, "verts": verts, "mano_verts": verts - root,
                "joints": joints - root, "mano_faces": self.mano.faces}


def attach_j2d(outputs: dict, Ks=None, root_xyz=None, ortho_intr=None,
               dat_name: str = "FreiHand") -> dict:
    """Project the predicted joints to 2D: for DART through its fitted
    orthographic camera `ortho_intr` (B, 3), otherwise in perspective
    through K after restoring the root."""
    if dat_name == "Dart":
        outputs["j2d"] = orthographic_project(outputs["joints"], ortho_intr)
        if "nimble_joints" in outputs:
            outputs["nimble_j2d"] = orthographic_project(outputs["nimble_joints"], ortho_intr)
    else:
        outputs["j2d"] = perspective_project(outputs["joints"] + root_xyz, Ks[:, :3, :3])
        if "nimble_joints" in outputs:
            outputs["nimble_j2d"] = perspective_project(outputs["nimble_joints"] + root_xyz,
                                                        Ks[:, :3, :3])
    return outputs


# scale of the hand heads' output layers in `init_weights`: at He scale, an
# untrained encoder's features (~1e2) give poses of hundreds of radians
HEAD_OUT_SCALE = 1e-3
# mano_new's dense layers (nn.Dense with flax's default init in JAX). Its
# *_fc1 outputs are not scaled by HEAD_OUT_SCALE: the branch renders
# nothing, so a far-from-mean random pose harms no render, and its init stays
# the distribution JAX draws
MANO_NEW_DENSE = ("beta_fc0", "beta_fc1", "theta_fc0", "theta_fc1")


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random initialisation from a torch.Generator, with flax's
    initialisers: zero biases, unit BatchNorm scales with running stats
    (0, 1), zero MMPool mix and vertex albedo; every conv as flax draws it,
    the s2d stems (ResNet's, EfficientNet's and HRNet's; C is 4 with
    `four_channel`) variance_scaling(2, fan_out, truncated) over the s2d
    kernel's (M, M, 4C, O) shape and every
    other conv (the encoders', the light estimator's) lecun_normal,
    truncated, with fan_in = (C_in / groups) k^2; the dense layers
    He-normal (fan_in), except mano_new's four (MANO_NEW_DENSE), which
    flax builds with its default lecun_normal (truncated, fan_in). The hand
    heads' output layers are scaled by HEAD_OUT_SCALE, so random weights
    predict a hand near MANO's mean pose and shape."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
                continue
            if isinstance(m, StemConv):
                variance_scaling_(m.weight, 2.0, m.taps ** 2 * m.weight.shape[0], gen)
            elif isinstance(m, nn.Conv2d):
                variance_scaling_(m.weight, 1.0, m.weight[0].numel(), gen)
            elif isinstance(m, nn.Linear) and name in MANO_NEW_DENSE:
                variance_scaling_(m.weight, 1.0, m.weight.shape[1], gen)
            elif isinstance(m, nn.Linear):
                w = m.weight
                scale = HEAD_OUT_SCALE if name.startswith("hand_encoder.") and name.endswith("_out") else 1.0
                w.copy_(torch.randn(w.shape, generator=gen) * (2.0 / w.shape[1]) ** 0.5 * scale)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith("mmpool.p") or name == "vert_tex":
                p.zero_()
    return model


def build_model(config: Config, device=None, seed: int = 0) -> HiFiHR:
    """The model in eval mode on `device` (CUDA unless the caller passes
    'cpu'), with seeded random weights. Conv weights are channels-last: the
    NHWC input permuted to NCHW already has that layout, so cuDNN needs no
    transposes."""
    from hifihr_tpu_torch import resolve_device

    dev = resolve_device(device)
    model = init_weights(HiFiHR(config), seed)
    return model.to(dev, memory_format=torch.channels_last).eval()
