"""The system under test: the port's own entry points, built as a user
builds them (`build_model`, `LossComputer`, `create_train_state`,
`make_train_step`), with the benchmark's seeded weights
loaded before the optimizer takes its views of them. This module and
tracing.py are the only ones that import `hifihr_tpu_torch`."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.weights import load_seeded_weights

VGG_SEED_SALT = 0x5EED  # the perceptual loss's VGG draws from seed + this


@dataclass
class Program:
    config: object  # hifihr_tpu_torch.config.Config
    model: torch.nn.Module
    step: object  # the train step
    state: object  # its TrainState
    sched: dict


def build_program(config_fields: dict, dataset: str, seed: int, device) -> Program:
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    cfg = Config.from_dict(config_fields)
    model = build_model(cfg, device=device)
    load_seeded_weights(model, seed, device)
    loss_computer = LossComputer(cfg)
    if loss_computer.vgg is not None:
        loss_computer.vgg.to(device)
        load_seeded_weights(loss_computer.vgg, seed + VGG_SEED_SALT, device)
    state = create_train_state(model, cfg)
    step = make_train_step(model, loss_computer, dataset, cfg)
    return Program(cfg, model, step, state, make_sched(cfg, 0, device))
