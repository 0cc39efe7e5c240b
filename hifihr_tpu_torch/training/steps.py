"""The train and eval steps (counterpart of hifihr_tpu/training/steps.py).

make_train_step: forward in train mode, the loss stack, backward through the
MSAA render (K2 forward, K3 backward), and Adam, with the skip guard on the
device: a step whose total loss is non-finite or under 1e-10 leaves the
parameters, the optimizer moments and the step count as they were, keeps
the new BatchNorm running stats, and never makes the host wait for the card.
make_eval_step: image -> joints, mesh, 2D joints and the rendered image,
silhouette and depth. Each step sets the model's mode on every call, so the
two can share one model.

Over several ranks (the loss computer's parallel/mesh.py Mesh; the model
placed on it by `replicate`, the state made with it) each rank steps on its
rows of the global batch: its loss terms are its shares of the global ones,
one all-reduce of the stacked terms gives every rank the global terms and
total, the skip guard decides on that total (so all ranks skip or step
together, still with no host sync), and the optimizer sums the flat
gradient over the ranks before it updates.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from hifihr_tpu_torch import resolve_device
from hifihr_tpu_torch.config import Config, STEPPED_LAMBDAS
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.models.hifihr import HiFiHR, attach_j2d
from hifihr_tpu_torch.training.train_state import TrainState
from hifihr_tpu_torch.utils import profiling

EVAL_KEYS = ("joints", "mano_verts", "j2d", "re_img", "re_sil", "re_depth",
             "pose_params", "shape_params", "trans", "scale", "hm_j2d")


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


def make_sched(config: Config, epoch: int, device=None) -> dict:
    """The stepped lambdas of `epoch` (train_hrnet.py:453-465) as device
    scalars, so a new epoch's values need no new step."""
    dev = resolve_device(device)
    return {f"lambda_{name}": torch.tensor(config.lambda_at_epoch(name, epoch), dtype=torch.float32,
                                           device=dev)
            for name in STEPPED_LAMBDAS}


def _root_center_targets(batch: dict, dat_name: str) -> dict:
    """GT joints/verts -> root-relative, as the reference training script does
    (train_hrnet.py:64-68): loaders give camera-absolute targets and
    root_xyz; the model predicts root-relative geometry."""
    if "root_xyz" in batch and "joints" in batch and dat_name != "HO3D_eval":
        batch = dict(batch)
        batch["joints"] = batch["joints"] - batch["root_xyz"]
        if "verts" in batch:
            batch["verts"] = batch["verts"] - batch["root_xyz"]
    return batch


def _forward(model: HiFiHR, batch: dict, dat_name: str, train: bool) -> dict:
    outputs = model(batch["imgs"], batch.get("Ks"), batch.get("root_xyz"),
                    dat_name=dat_name, mode_train=train)
    return attach_j2d(outputs, Ks=batch.get("Ks"), root_xyz=batch.get("root_xyz"),
                      ortho_intr=batch.get("ortho_intr"), dat_name=dat_name)


def make_train_step(model: HiFiHR, loss_computer: LossComputer, dat_name: str,
                    config: Config) -> Callable:
    """Returns train_step(state, batch, sched) -> (state, loss_dict). `state`
    is updated in place and returned; loss_dict holds the fired terms,
    'total' and 'skipped' (1.0 for a skipped step), as device scalars; over
    several ranks `batch` is this rank's rows and the terms are global."""
    del config  # the model and the loss computer carry it; kept for the JAX signature
    set_fp32_numerics()
    mesh = loss_computer.mesh
    if mesh is not None and mesh.world > 1:
        from hifihr_tpu_torch.networks.batchnorm import FlaxBatchNorm

        if any(m.batch_group is None for m in model.modules() if isinstance(m, FlaxBatchNorm)):
            raise ValueError("the model's BatchNorms are not on the mesh: place it with parallel.mesh.replicate")

    def train_step(state: TrainState, batch: dict, sched: dict):
        if state.optimizer.mesh is not mesh:
            raise ValueError("the train state and the loss computer were made for different meshes")
        with profiling.span("step", new_step=True):
            model.train()
            batch = _root_center_targets(normalize_batch(batch), dat_name)
            with profiling.span("optimizer"):
                state.optimizer.zero_grad()
            loss_dic = loss_computer(batch, _forward(model, batch, dat_name, train=True), dat_name, sched)
            with profiling.span("backward"):
                loss_dic["total"].backward()
            loss_dic = {k: v.detach() for k, v in loss_dic.items()}
            if mesh is not None and mesh.distributed:  # the shares summed into the global terms
                terms = torch.stack(list(loss_dic.values()))
                dist.all_reduce(terms, group=mesh.group)
                loss_dic = dict(zip(loss_dic, terms.unbind()))
            with profiling.span("optimizer"):
                total = loss_dic["total"]
                ok = torch.isfinite(total) & (total > 1e-10)
                state.optimizer.step(ok)
                loss_dic["skipped"] = 1.0 - ok.float()
        return state, loss_dic

    return train_step


def make_eval_step(model: HiFiHR, dat_name: str, config: Config) -> Callable:
    """Returns eval_step(batch) -> outputs dict, run in eval mode under
    inference_mode on the model's device. `batch` holds 'imgs' (B, S, S, 3)
    uint8 or float, 'Ks' (B, 3, 3) and 'root_xyz' (B, 1, 3) on that device."""
    del config  # the model carries it; kept for the JAX signature
    set_fp32_numerics()

    def eval_step(batch: dict) -> dict:
        model.eval()
        with torch.inference_mode():
            outputs = _forward(model, normalize_batch(batch), dat_name, train=False)
            return {k: outputs[k] for k in EVAL_KEYS if outputs.get(k) is not None}

    return eval_step
