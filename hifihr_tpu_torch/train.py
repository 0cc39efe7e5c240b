"""Training and evaluation entry (counterpart of the root train.py):

    python -m hifihr_tpu_torch.train --config_json configs/smoke_render.json \
        [--mode training|evaluation] [--device cuda|cpu]

On N cards of one host (the JAX package's Trainer takes every local device
by itself; here one process per card):

    torchrun --nproc_per_node=N -m hifihr_tpu_torch.train \
        --config_json ... [--dist_backend nccl|gloo]

Under torchrun (WORLD_SIZE in the environment) each process starts the
process group with `--dist_backend` (nccl by default; gloo for ranks that
share a card, or with --device cpu) on cuda:LOCAL_RANK; the config's
train_batch is the global batch and `fsdp` shards the optimizer state
(hifihr_tpu_torch/parallel/mesh.py). A process group that the caller
started already is used as it is. Without either, one card, as before.

The JSON config selects the datasets, the supervision, the encoder, the hand
model and the λ weights; the same entry trains and evaluates. It runs on
CUDA unless `--device cpu` is given. The datasets come from the config's
paths: FreiHAND, RHD, HO-3D and DART (data/{freihand,rhd,ho3d,dart}.py);
where FreiHAND's path is not set or missing, the synthetic stand-in serves
its batches, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

def build_loaders(config):
    """The train loader (one BatchLoader per train dataset, round-robin
    through a ConcatLoader when there are several) and the val loader, as
    the JAX package's train.py builds them."""
    from hifihr_tpu_torch.data.base import BatchLoader, ConcatLoader, Subset
    from hifihr_tpu_torch.data.synthetic import SyntheticHandDataset

    def dataset_for(name: str, split: str, queries):
        if name == "FreiHand":
            if config.freihand_base_path and os.path.exists(config.freihand_base_path):
                from hifihr_tpu_torch.data.freihand import FreiHand

                return FreiHand(config.freihand_base_path, split=split,
                                queries=queries, semi_ratio=config.semi_ratio,
                                four_channel=config.four_channel,
                                decode_cache=config.decode_cache or None)
            logging.warning("FreiHAND data not found; using the synthetic stand-in")
            size = config.controlled_size if config.controlled_exp else 256
            return SyntheticHandDataset(size=size, image_size=config.image_size)
        if name == "RHD":
            from hifihr_tpu_torch.data.rhd import RHD

            return RHD(config.rhd_base_path, split=split, queries=queries)
        if name == "HO3D":
            from hifihr_tpu_torch.data.ho3d import HO3D

            return HO3D(config.ho3d_base_path, split=split, queries=queries)
        if name == "Dart":
            from hifihr_tpu_torch.data.dart import DARTset

            return DARTset(config.dart_base_path, split=split)
        raise ValueError(name)

    train_loaders = []
    for name in config.train_datasets:
        q = {
            "FreiHand": config.train_queries_frei,
            "RHD": config.train_queries_rhd,
            "HO3D": config.train_queries_ho3d,
            "Dart": config.train_queries_dart,
        }.get(name) or config.train_queries
        ds = dataset_for(name, "training", q)
        # controlled-size experiments subset any training dataset
        # (reference data/dataset.py:97-106 limit_size)
        if config.controlled_exp and not isinstance(ds, SyntheticHandDataset):
            ds = Subset(ds, config.controlled_size)
        train_loaders.append(BatchLoader(ds, config.train_batch, num_workers=config.num_workers))
    train_loader = ConcatLoader(train_loaders) if len(train_loaders) > 1 else train_loaders[0]

    val_loader = None
    if config.val_datasets:
        ds = dataset_for(config.val_datasets[0], "evaluation", config.val_queries)
        val_loader = BatchLoader(ds, config.val_batch, shuffle=False, drop_last=False,
                                 num_workers=config.num_workers)
    return train_loader, val_loader


def load_eval_gt(config, val_loader=None):
    """FreiHAND's evaluation_xyz.json and evaluation_verts.json under its
    base path; else, for the synthetic stand-in, its own exact ground truth
    (Procrustes alignment absorbs the root convention); else None."""
    from hifihr_tpu_torch.data.synthetic import SyntheticHandDataset

    base = config.freihand_base_path
    if base:
        xyz_p = os.path.join(base, "evaluation_xyz.json")
        verts_p = os.path.join(base, "evaluation_verts.json")
        if os.path.exists(xyz_p) and os.path.exists(verts_p):
            with open(xyz_p) as f:
                xyz = np.asarray(json.load(f), np.float32)
            with open(verts_p) as f:
                verts = np.asarray(json.load(f), np.float32)
            return {"xyz": xyz, "verts": verts}
    ds = getattr(val_loader, "dataset", None)
    if isinstance(ds, SyntheticHandDataset):
        return {"xyz": ds.joints, "verts": ds.verts}
    return None


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train or evaluate hifihr_tpu_torch from a JSON config.")
    parser.add_argument("--config_json", type=str, required=True)
    parser.add_argument("--mode", type=str, default=None, choices=["training", "evaluation"])
    parser.add_argument("--device", type=str, default=None, choices=["cuda", "cpu"],
                        help="default: cuda (cuda:LOCAL_RANK under torchrun)")
    parser.add_argument("--dist_backend", type=str, default="nccl", choices=["nccl", "gloo"],
                        help="the process group's backend under torchrun (gloo for ranks that share a card)")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from hifihr_tpu_torch import resolve_device
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from hifihr_tpu_torch.training.loop import Trainer

    config = Config.from_json(args.config_json)
    started = False
    if dist.is_initialized():
        device = resolve_device(args.device or _rank_device())
    elif "WORLD_SIZE" in os.environ:
        device = init_distributed(args.dist_backend, device=args.device)
        started = True
    else:
        device = resolve_device(args.device)
    mesh = make_mesh(config.fsdp, device)
    os.makedirs(config.base_out_path, exist_ok=True)
    root = logging.getLogger()
    # rank 0 alone logs and writes train.log; the other ranks' records go to
    # a NullHandler (logging's module functions would otherwise give them a
    # stderr handler of their own)
    handlers = [logging.StreamHandler(),
                logging.FileHandler(os.path.join(config.base_out_path, "train.log"))] if mesh.rank == 0 else [
        logging.NullHandler()]
    for h in handlers:
        h.setFormatter(logging.Formatter(logging.BASIC_FORMAT))
        root.addHandler(h)
    root.setLevel(logging.INFO)
    trainer = None
    try:
        logging.info("config: %s", config)
        model = build_model(config, device=device, seed=config.seed)
        train_loader, val_loader = build_loaders(config)
        trainer = Trainer(config, model, train_loader, val_loader,
                          eval_gt=load_eval_gt(config, val_loader), out_dir=config.base_out_path, mesh=mesh)
        mode = args.mode or (config.mode[0] if config.mode else "training")
        if mode == "evaluation":
            result = trainer.evaluate()
            logging.info("evaluation: %s", result)
        else:
            result = trainer.fit()
            logging.info("best PA-MPJPE (cm): %s", result)
        return result
    finally:
        if trainer is not None:
            trainer.close()
        for h in handlers:
            root.removeHandler(h)
            h.close()
        if started:
            dist.destroy_process_group()


def _rank_device() -> str:
    """The card of this rank in a process group started by the caller:
    cuda:LOCAL_RANK % device_count (LOCAL_RANK defaults to the rank)."""
    import torch
    import torch.distributed as dist

    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return f"cuda:{local % max(torch.cuda.device_count(), 1)}"


if __name__ == "__main__":
    main()
