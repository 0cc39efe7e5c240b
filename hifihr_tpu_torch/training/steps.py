"""The eval step (counterpart of hifihr_tpu/training/steps.py::
normalize_batch and make_eval_step): image -> joints, mesh, 2D joints and
the rendered image, silhouette and depth."""

from __future__ import annotations

from typing import Callable

import torch

from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.models.hifihr import HiFiHR, attach_j2d

EVAL_KEYS = ("joints", "mano_verts", "j2d", "re_img", "re_sil", "re_depth",
             "pose_params", "shape_params", "trans", "scale")


def normalize_batch(batch: dict) -> dict:
    """uint8 images -> float in [0, 1]; uint8 masks -> float."""
    batch = dict(batch)
    if "imgs" in batch and batch["imgs"].dtype == torch.uint8:
        batch["imgs"] = batch["imgs"].float() / 255.0
    if "segms_gt" in batch and batch["segms_gt"].dtype == torch.uint8:
        batch["segms_gt"] = batch["segms_gt"].float()
    return batch


def set_fp32_numerics() -> None:
    """Full fp32 for the fp32 parts on the card: no TF32 in cuDNN convs (on
    by default in PyTorch) or in matmuls. Process-wide PyTorch flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def make_eval_step(model: HiFiHR, dat_name: str, config: Config) -> Callable:
    """Returns eval_step(batch) -> outputs dict, run under inference_mode on
    the model's device. `batch` holds 'imgs' (B, S, S, 3) uint8 or float,
    'Ks' (B, 3, 3) and 'root_xyz' (B, 1, 3) on that device."""
    del config  # the model carries it; kept for the JAX signature
    set_fp32_numerics()
    model.eval()

    def eval_step(batch: dict) -> dict:
        with torch.inference_mode():
            batch = normalize_batch(batch)
            outputs = model(batch["imgs"], batch.get("Ks"), batch.get("root_xyz"),
                            dat_name=dat_name, mode_train=False)
            outputs = attach_j2d(outputs, Ks=batch.get("Ks"), root_xyz=batch.get("root_xyz"))
            return {k: outputs[k] for k in EVAL_KEYS if outputs.get(k) is not None}

    return eval_step
