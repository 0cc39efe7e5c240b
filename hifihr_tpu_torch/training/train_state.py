"""Train state and optimiser (counterpart of
hifihr_tpu/training/train_state.py): Adam or AdamW with optax's constants,
a MultiStepLR-style piecewise-constant learning rate, and module freezing.

The reference recipe: Adam/AdamW + MultiStepLR(lr_steps, lr_gamma)
(train_hrnet.py:546-554), with `force_init_lr` overriding the initial rate
(:557-558). The imagenet warm start of the JAX package waits until converted
encoder weights are in the repository.

`Adam` keeps every trained parameter as a view into one flat fp32 buffer,
and its gradient as a view into another, so one update is a handful of
elementwise kernels over the flat buffers, not a loop over ~160 tensors.
It updates only where a device flag `ok` holds, and leaves the parameters,
both moments and the step count exactly as they were where it does not: the
train step's skip guard, with no host sync. Create the state after the
model is on its device: moving the model afterwards breaks the views.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from hifihr_tpu_torch import constant
from hifihr_tpu_torch.config import Config

# optax.adam / optax.adamw defaults
B1, B2, EPS = 0.9, 0.999, 1e-8
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default (torch's AdamW uses 1e-2)


def make_lr_schedule(config: Config, steps_per_epoch: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """MultiStepLR over update counts: lr = lr0 * lr_gamma ** (number of
    boundaries e * steps_per_epoch, e in lr_steps, that the count has
    reached); lr0 is force_init_lr when positive, else init_lr (optax's
    piecewise_constant_schedule). The returned function maps a device count
    to a device rate."""
    lr0 = config.init_lr if config.force_init_lr <= 0 else config.force_init_lr
    bounds = sorted({int(e) * steps_per_epoch for e in config.lr_steps})

    def schedule(count: torch.Tensor) -> torch.Tensor:
        passed = (count >= constant(bounds, count.device, count.dtype)).sum()
        return lr0 * torch.pow(config.lr_gamma, passed.float())

    return schedule


class Adam:
    """optax.adam (weight_decay=0) or optax.adamw over one flat buffer:

      mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2,   t = count + 1
      p -= lr(count) * [mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd p]
    """

    def __init__(self, params: list[nn.Parameter], schedule: Callable, weight_decay: float = 0.0):
        if not params:
            raise ValueError("Adam: no parameter to train")
        dev = params[0].device
        n = sum(p.numel() for p in params)
        self.params = params
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.flat = torch.empty(n, dtype=torch.float32, device=dev)
        self.grad = torch.zeros_like(self.flat)
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self._grad_views = []
        off = 0
        for p in params:
            if p.dtype != torch.float32 or p.device != dev:
                raise TypeError(f"Adam: need float32 parameters on {dev}, got {p.dtype} on {p.device}")
            # same shape and strides (channels-last convs stay channels-last)
            view = self.flat.as_strided(p.shape, p.stride(), off)
            view.copy_(p.detach())
            p.data = view
            self._grad_views.append(self.grad.as_strided(p.shape, p.stride(), off))
            off += p.numel()

    def zero_grad(self) -> None:
        """Zero the flat gradient and point every .grad at its view of it;
        backward then accumulates into the flat buffer."""
        self.grad.zero_()
        for p, g in zip(self.params, self._grad_views):
            p.grad = g

    @torch.no_grad()
    def step(self, ok: torch.Tensor) -> None:
        """One update where the device bool `ok` holds, none where it does
        not. The gate selects (torch.where) and never multiplies, since the
        gradient of a skipped step may hold NaN and 0 * NaN is NaN."""
        g = self.grad
        mu = g.mul(1.0 - B1).add_(self.mu, alpha=B1)
        nu = g.square().mul_(1.0 - B2).add_(self.nu, alpha=B2)
        t = (self.count + 1).float()
        update = (mu / (1.0 - torch.pow(B1, t))) / ((nu / (1.0 - torch.pow(B2, t))).sqrt_().add_(EPS))
        if self.weight_decay:
            update.add_(self.flat, alpha=self.weight_decay)
        new = self.flat - self.schedule(self.count) * update
        torch.where(ok, mu, self.mu, out=self.mu)
        torch.where(ok, nu, self.nu, out=self.nu)
        torch.where(ok, new, self.flat, out=self.flat)
        self.count.add_(ok.to(self.count.dtype))


def freeze_submodules(model: nn.Module, frozen_prefixes: tuple[str, ...]) -> list[nn.Parameter]:
    """The parameters to train: those whose '/'-joined name (the flax path,
    e.g. 'hand_encoder/base_fc0/weight') starts with none of
    `frozen_prefixes`. The others get requires_grad=False, so they take no
    update, as optax.multi_transform with set_to_zero gives them; in train
    mode their BatchNorm statistics still move."""
    trained = []
    for name, p in model.named_parameters():
        frozen = any(name.replace(".", "/").startswith(pre) for pre in frozen_prefixes)
        p.requires_grad_(not frozen)
        if not frozen:
            trained.append(p)
    return trained


@dataclass
class TrainState:
    """The model (parameters and BatchNorm running stats) and the optimizer,
    whose device counter `step` counts the updates taken."""

    model: nn.Module
    optimizer: Adam

    @property
    def step(self) -> torch.Tensor:
        return self.optimizer.count


def create_train_state(model: nn.Module, config: Config, sample_batch: dict | None = None,
                       steps_per_epoch: int = 1000) -> TrainState:
    """Adam (or AdamW) over the model's trained parameters. `sample_batch`
    is the JAX signature's init batch: the port's model already holds its
    weights (build_model, or a converted state dict), so it is not read.
    Freezing follows the reference (utils/train_utils.py:205-240):
    only_train_regressor freezes the encoder, the light estimator and the
    albedo; only_train_texture the encoder and the hand heads' base, pose
    and shape layers."""
    del sample_batch
    frozen: tuple[str, ...] = ()
    if config.only_train_regressor:
        frozen = ("encoder", "light_estimator", "hand_encoder/tex", "vert_tex")
    elif config.only_train_texture:
        frozen = ("encoder", "rgb2hm", "hand_encoder/base", "hand_encoder/pose",
                  "hand_encoder/shape")
    wd = ADAMW_WEIGHT_DECAY if config.optimizer == "AdamW" else 0.0
    opt = Adam(freeze_submodules(model, frozen), make_lr_schedule(config, steps_per_epoch), wd)
    return TrainState(model, opt)
