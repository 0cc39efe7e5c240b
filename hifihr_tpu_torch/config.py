"""The port's configuration: the fields of hifihr_tpu/config.py::Config that
the ported slices read, with the same names and defaults, so one dict builds
both."""

from __future__ import annotations

from dataclasses import dataclass

ENCODERS = ("res18", "res50", "res101")
HAND_MODELS = ("mano", "nimble")
AA_MODES = ("msaa", "ssaa")
BASE_LOSS_FNS = ("L1", "L2")
OPTIMIZERS = ("Adam", "AdamW")
# the branches of losses/stack.py that the port has; the photometric triples
# fire on presence (texture_con, segms_gt), not by name
PORTED_LOSSES = ("joint_2d", "joint_3d", "vert_3d", "bone_direc", "edge_length", "mscale", "sil",
                 "iou", "mshape", "mpose", "mtex")
STEPPED_LAMBDAS = ("j2d_gt", "shape", "pose", "tex_reg")


@dataclass(frozen=True)
class Config:
    pretrain: str = "res50"
    hand_model: str = "mano"
    use_mean_shape: bool = False
    render: bool = True
    light_estimation: bool = True
    image_size: int = 224
    aa_factor: int = 3
    # 'msaa': the rasteriser tests aa_factor x aa_factor subsamples per pixel
    # and shading runs once per pixel; 'ssaa': reference-exact, rasterise
    # and shade at aa_factor x the resolution, then average-pool
    aa_mode: str = "msaa"
    # NIMBLE's MSAA render samples its appearance at the face corners
    # (False, per-fragment UV sampling, is not ported)
    nimble_corner_tex: bool = True
    # encoder compute dtype; parameters stay float32
    compute_dtype: str = "bfloat16"
    rgb2hm: bool = False

    # losses (losses_frei/_rhd override `losses` per dataset)
    losses: tuple = ("mscale",)
    losses_frei: tuple = ()
    losses_rhd: tuple = ()
    base_loss_fn: str = "L2"
    lambda_texture: float = 0.003
    lambda_silhouette: float = 0.005
    lambda_j3d: float = 100.0
    lambda_vert_3d: float = 100.0
    lambda_mrgb: float = 1e-3
    lambda_iou: float = 1e-3
    lambda_bone_direc: float = 0.1
    lambda_ssim_tex: float = 0.001
    lambda_mscale: float = 0.1
    lambda_edge_len: float = 0.1
    # stepped schedules: value_list[i] applies from epoch steps[i-1]
    lambda_j2d_gt_list: tuple = (1e-5,)
    lambda_j2d_gt_steps: tuple = ()
    lambda_shape_list: tuple = (1e-5,)
    lambda_shape_steps: tuple = ()
    lambda_pose_list: tuple = (1e-4,)
    lambda_pose_steps: tuple = ()
    lambda_tex_reg_list: tuple = (1e-5,)
    lambda_tex_reg_steps: tuple = ()

    # optimisation
    optimizer: str = "Adam"
    init_lr: float = 1e-3
    force_init_lr: float = -1.0
    lr_steps: tuple = (50,)
    lr_gamma: float = 0.001
    only_train_regressor: bool = False
    only_train_texture: bool = False

    def __post_init__(self):
        if self.pretrain not in ENCODERS:
            raise ValueError(f"pretrain={self.pretrain!r}: the port has {ENCODERS}")
        if self.hand_model not in HAND_MODELS:
            raise NotImplementedError(f"hand_model={self.hand_model!r}: the port has {HAND_MODELS}")
        if self.aa_mode not in AA_MODES:
            raise NotImplementedError(f"aa_mode={self.aa_mode!r}: the port has {AA_MODES}")
        if self.hand_model == "nimble" and self.render and (self.aa_mode != "msaa" or not self.nimble_corner_tex):
            raise NotImplementedError("NIMBLE renders in the port with aa_mode='msaa' and nimble_corner_tex=True "
                                      "only; the per-fragment UV path is not ported")
        if self.rgb2hm:
            raise NotImplementedError("rgb2hm: the heatmap branch is not ported")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}")
        unported = sorted(set(self.losses + self.losses_frei + self.losses_rhd) - set(PORTED_LOSSES))
        if unported:
            raise NotImplementedError(f"losses {unported}: the port has {PORTED_LOSSES}")
        if self.base_loss_fn not in BASE_LOSS_FNS:
            raise ValueError(f"base_loss_fn must be one of {BASE_LOSS_FNS}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}")
        for name in STEPPED_LAMBDAS:
            if len(getattr(self, f"lambda_{name}_list")) != len(getattr(self, f"lambda_{name}_steps")) + 1:
                raise ValueError(f"lambda_{name}_list must have len(steps)+1 entries")

    def lambda_at_epoch(self, name: str, epoch: int) -> float:
        """Current value of a stepped lambda ('j2d_gt'|'shape'|'pose'|'tex_reg')."""
        lst = getattr(self, f"lambda_{name}_list")
        steps = getattr(self, f"lambda_{name}_steps")
        return float(lst[sum(1 for s in steps if epoch >= s)])

    @property
    def ncomps(self):
        """(shape, pose, tex) component counts (models_res_nimble.py:55-60)."""
        if self.hand_model == "nimble":
            return (20, 30, 10)
        return (10, 48, None)
