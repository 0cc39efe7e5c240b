"""The port's configuration: every field of hifihr_tpu/config.py::Config, with
the same names and defaults, and its JSON loader, so one shipped config file
builds both packages.

A value the port cannot run as the JAX package does raises
NotImplementedError naming the feature; an unknown value raises ValueError,
as in the JAX package. `pretrain="none"` builds here, as in the JAX package,
and the model raises ValueError for it (models/hifihr.py).
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass

ENCODERS = ("res18", "res50", "res101", "hr18sv2", "effb3", "none")
HAND_MODELS = ("mano", "nimble", "mano_new")
DATASETS = ("FreiHand", "RHD", "HO3D", "Dart")
AA_MODES = ("msaa", "ssaa")
BASE_LOSS_FNS = ("L1", "L2")
OPTIMIZERS = ("Adam", "AdamW")
# the names of losses/stack.py's branches: every name the JAX package's stack
# reads. texture, mrgb, ssim_tex and their _self forms are accepted and fire
# on presence (segms_gt, texture_con in the batch), not by name, as in the
# JAX package
PORTED_LOSSES = ("joint_2d", "joint_3d", "vert_3d", "bone_direc", "bone_direc_3d", "edge_length", "mscale",
                 "scale", "open_2dj", "open_2dj_de", "joint_3d_norm", "open_bone_direc", "kp_cons",
                 "hm_integral", "hm_integral_gt", "tsa_poses", "tsa_pose", "perceptual", "sil", "iou",
                 "triangle", "mshape", "mpose", "mtex",
                 "texture", "mrgb", "ssim_tex", "texture_self", "mrgb_self", "ssim_tex_self")
STEPPED_LAMBDAS = ("j2d_gt", "shape", "pose", "tex_reg")

# JSON keys the JAX package drops on purpose (hifihr_tpu/config.py:41-45,
# where each is explained); any other unknown key warns
_KNOWN_IGNORED_KEYS = frozenset({
    "train_requires", "test_requires", "writer_topic",
    "demo_freq_evaluation", "mode_0", "lambda_pose", "lambda_j2d_gt",
    "pretrain_segmnet", "new_model", "task", "val_interval",
})


@dataclass(frozen=True)
class Config:
    # model
    pretrain: str = "res50"
    hand_model: str = "mano"
    use_mean_shape: bool = False
    render: bool = True
    light_estimation: bool = True
    four_channel: bool = False
    image_size: int = 224
    aa_factor: int = 3
    # 'msaa': the rasteriser tests aa_factor x aa_factor subsamples per pixel
    # and shading runs once per pixel; 'ssaa': reference-exact, rasterise
    # and shade at aa_factor x the resolution, then average-pool
    aa_mode: str = "msaa"
    # NIMBLE's MSAA render samples its appearance at the face corners;
    # False samples the UV maps per fragment (the SSAA render always does)
    nimble_corner_tex: bool = True
    rgb2hm: bool = False  # the stacked-hourglass heatmap branch
    freeze_hm_estimator: bool = False
    # the ('data', 'fsdp') mesh's fsdp size: the optimizer state shards over
    # fsdp ranks (hifihr_tpu_torch/parallel/mesh.py, training/train_state.py)
    fsdp: int = 1
    # encoder compute dtype; parameters stay float32
    compute_dtype: str = "bfloat16"

    # data (hifihr_tpu_torch/train.py::build_loaders reads FreiHAND, RHD,
    # HO3D and DART from these paths; the synthetic stand-in where
    # FreiHAND's is missing)
    train_datasets: tuple = ("FreiHand",)
    val_datasets: tuple = ("FreiHand",)
    train_queries: tuple = ("trans_images", "trans_Ks", "trans_joints")
    val_queries: tuple = ("images", "Ks", "joints")
    train_queries_frei: tuple = ()
    train_queries_rhd: tuple = ()
    train_queries_ho3d: tuple = ()
    train_queries_dart: tuple = ()
    freihand_base_path: str | None = None
    rhd_base_path: str | None = None
    ho3d_base_path: str | None = None
    dart_base_path: str | None = None
    controlled_exp: bool = False
    controlled_size: int = 3000
    semi_ratio: float | None = None

    # losses (losses_frei/_rhd override `losses` per dataset)
    losses: tuple = ("mscale",)
    losses_frei: tuple = ()
    losses_rhd: tuple = ()
    base_loss_fn: str = "L2"
    lambda_laplacian: float = 0.1
    lambda_texture: float = 0.003
    lambda_silhouette: float = 0.005
    lambda_j2d: float = 1e-3
    lambda_j2d_de: float = 1e-4
    lambda_j3d: float = 100.0
    lambda_j3d_norm: float = 100.0
    lambda_vert_3d: float = 100.0
    lambda_mrgb: float = 1e-3
    lambda_iou: float = 1e-3
    lambda_bone_direc: float = 0.1
    lambda_bone_direc_3d: float = 0.1
    lambda_edge_len: float = 0.1
    lambda_percep: float = 1e-5
    lambda_hm: float = 1e-3
    lambda_kp_cons: float = 2e-4
    lambda_ssim_tex: float = 0.001
    lambda_scale: float = 100.0
    lambda_mscale: float = 0.1
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
    total_epochs: int = 100
    train_batch: int = 8
    val_batch: int = 8
    num_workers: int = 8
    decode_cache: str = ""  # the FreiHAND loader's decoded-frame snapshot dir
    save_interval: int = 1
    save_mode: str = "separately"
    only_train_regressor: bool = False
    only_train_texture: bool = False

    # checkpointing / resume
    pretrain_model: str | None = None
    pretrain_texture_model: str | None = None
    pretrain_rgb2hm: str | None = None
    # a converted imagenet encoder npz to start from
    # (hifihr_tpu_torch/utils/weights.py::merge_npz_into_model)
    encoder_imagenet_npz: str | None = None

    seed: int = 0  # the seed of build_model's init in hifihr_tpu_torch/train.py

    # logging
    base_out_path: str = "output/debug"
    demo_freq: int = 100
    print_freq: int = 100
    is_write_tb: bool = False

    # the reference's passthroughs
    mode: tuple = ("training",)
    is_val: bool = False
    if_test: bool = True
    # the test-time MANO fit in the Trainer's eval (training/fitting.py);
    # applied to hand_model "mano" only, as in the JAX package
    test_refinement: bool = False
    save_2d: bool = False
    save_3d: bool = False
    img_wise_save: bool = False

    def __post_init__(self):
        if self.pretrain not in ENCODERS:
            raise ValueError(f"unknown encoder pretrain={self.pretrain!r}; valid: {ENCODERS}")
        if self.hand_model not in HAND_MODELS:
            raise ValueError(f"unknown hand_model={self.hand_model!r}; valid: {HAND_MODELS}")
        for d in tuple(self.train_datasets) + tuple(self.val_datasets):
            if d not in DATASETS:
                raise ValueError(f"unknown dataset {d!r}; valid: {DATASETS}")
        if self.aa_mode not in AA_MODES:
            raise NotImplementedError(f"aa_mode={self.aa_mode!r}: the port has {AA_MODES}")
        if self.fsdp < 1:
            raise ValueError(f"fsdp={self.fsdp!r} must be at least 1")
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

    @staticmethod
    def from_json(path: str, **overrides) -> "Config":
        """A shipped JSON config (configs/**/*.json), with `overrides`
        replacing its keys."""
        with open(path) as f:
            raw = json.load(f)
        raw.update(overrides)
        return Config.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "Config":
        """Lists become tuples; the keys in _KNOWN_IGNORED_KEYS are dropped,
        and any other key that is not a field is dropped with a warning."""
        fields = {f.name for f in dataclasses.fields(Config)}
        kwargs = {}
        dropped = []
        for k, v in raw.items():
            if k not in fields:
                if k not in _KNOWN_IGNORED_KEYS:
                    dropped.append(k)
                continue
            kwargs[k] = tuple(v) if isinstance(v, list) else v
        if dropped:
            warnings.warn(f"config keys not modelled by Config (ignored): {sorted(dropped)}", stacklevel=2)
        return Config(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
