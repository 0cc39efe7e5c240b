"""Composite hand reconstruction model, MANO branch (counterpart of
hifihr_tpu/models/hifihr.py::HiFiHR and attach_j2d).

encoder -> light estimator -> hand parameter heads -> MANO -> root-centering
-> MSAA render. Outputs keep the JAX keys and layouts: images NHWC, re_img
(B, S, S, 3), re_sil (B, S, S, 1) in {0, 255}, re_depth (B, S, S),
maskRGBs. The encoder runs in `config.compute_dtype` (bf16 autocast on the
card); everything after it runs in fp32.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from hifihr_tpu_torch import constant
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.geometry.projection import perspective_project
from hifihr_tpu_torch.hand.mano import ManoLayer, regress_joints_frei
from hifihr_tpu_torch.networks.heads import HandEncoder, LightEstimator
from hifihr_tpu_torch.networks.resnet import ResNetEncoder
from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings
from hifihr_tpu_torch.render.shading import DirectionalLight

ROOT_ID = 9  # FreiHAND middle-MCP root


class HiFiHR(nn.Module):
    """Parameter names follow the flax tree (`encoder.backbone.layer1_0...`,
    `hand_encoder.base_fc0`, `light_estimator.conv1`, `vert_tex`), so
    `hifihr_tpu_torch.convert.state_dict_from_flax` maps them one to one."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        self.encoder = ResNetEncoder(config.pretrain)
        backbone = self.encoder.backbone
        shape_nc, pose_nc, _ = config.ncomps
        self.hand_encoder = HandEncoder(backbone.out_channels, shape_nc, pose_nc,
                                        config.use_mean_shape)
        if config.light_estimation:
            self.light_estimator = LightEstimator(backbone.low_channels)
        self.mano = ManoLayer(ncomps=pose_nc - 3)
        if config.render:
            self.vert_tex = nn.Parameter(torch.zeros(778, 3))
            self.renderer = PhongRenderer(
                self.mano.faces_np, self.mano.v_template_np,
                RenderSettings(image_size=config.image_size, aa_factor=config.aa_factor),
            )

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
        """images (B, S, S, 3) float in [0, 1]; Ks (B, 3, 3); root_xyz (B, 1, 3)."""
        cfg = self.config
        b = images.shape[0]
        with self._encoder_autocast(images.device):
            low, features = self.encoder(images)
        light_params = None
        if cfg.light_estimation:
            light_params = self.light_estimator(low.float())

        hand_params = self.hand_encoder(features)
        outputs = dict(hand_params)
        mano_out = self.mano(hand_params["pose_params"], hand_params["shape_params"])
        verts = mano_out.verts
        joints = regress_joints_frei(verts, self.mano.J_regressor)
        outputs["tsa_poses"] = mano_out.full_pose

        if dat_name == "HO3D" and not mode_train:
            pred_root = joints[:, 0:1]
        else:
            pred_root = joints[:, ROOT_ID:ROOT_ID + 1]
        outputs["joints"] = joints - pred_root
        outputs["mano_verts"] = verts - pred_root

        if cfg.render and Ks is not None and root_xyz is not None:
            render_verts = outputs["mano_verts"] + root_xyz
            if light_params is not None:
                light = DirectionalLight.from_estimator(light_params["colors"],
                                                        light_params["directions"])
            else:
                light = DirectionalLight.default(b, images.dtype, images.device)
            rgba = self.renderer(render_verts, self._vertex_albedo(b), Ks[:, :3, :3], light)
            re_sil = (rgba[..., 3:4] > 0).to(images.dtype) * 255.0
            outputs["re_img"] = rgba[..., :3]
            outputs["re_sil"] = re_sil
            outputs["re_depth"] = rgba[..., 4]
            outputs["maskRGBs"] = images * (re_sil > 0).to(images.dtype)

        outputs["mano_faces"] = self.mano.faces
        if light_params is not None:
            outputs["light_params"] = light_params
        return outputs


def attach_j2d(outputs: dict, Ks=None, root_xyz=None) -> dict:
    """Project the predicted joints to 2D after restoring the root
    (perspective through K)."""
    outputs["j2d"] = perspective_project(outputs["joints"] + root_xyz, Ks[:, :3, :3])
    return outputs


# scale of the hand heads' output layers in `init_weights`: at He scale, an
# untrained encoder's features (~1e2) give poses of hundreds of radians
HEAD_OUT_SCALE = 1e-3


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random initialisation from a torch.Generator: He-normal
    (fan_out) convs, He-normal (fan_in) dense layers, zero biases, unit
    BatchNorm scales with running stats (0, 1), zero MMPool mix and vertex
    albedo, as the flax initialisers do; the hand heads' output layers are
    scaled by HEAD_OUT_SCALE, so random weights predict a hand near MANO's
    mean pose and shape."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                fan = w.shape[0] * w[0, 0].numel() if isinstance(m, nn.Conv2d) else w.shape[1]
                scale = HEAD_OUT_SCALE if name.startswith("hand_encoder.") and name.endswith("_out") else 1.0
                w.copy_(torch.randn(w.shape, generator=gen) * (2.0 / fan) ** 0.5 * scale)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
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
