"""Train state and optimiser (counterpart of
hifihr_tpu/training/train_state.py): Adam or AdamW with optax's constants,
a MultiStepLR-style piecewise-constant learning rate, and module freezing.

The reference recipe: Adam/AdamW + MultiStepLR(lr_steps, lr_gamma)
(train_hrnet.py:546-554), with `force_init_lr` overriding the initial rate
(:557-558). `create_train_state` starts the encoder from a converted imagenet
npz when there is one (utils/weights.py::encoder_npz_for).

`Adam` keeps every trained parameter as a view into one flat fp32 buffer,
and its gradient as a view into another, so one update is a handful of
elementwise kernels over the flat buffers, not a loop over ~160 tensors.
It updates only where a device flag `ok` holds, and leaves the parameters,
both moments and the step count exactly as they were where it does not: the
train step's skip guard, with no host sync. Create the state after the
model is on its device: moving the model afterwards breaks the views.

Over several ranks (a parallel/mesh.py Mesh) each rank's gradient is that
of its share of the global loss (losses/stack.py), so the global gradient
is their sum: one all-reduce of the flat gradient after backward, with no
DDP wrapper. DDP would bucket the gradients into buffers of its own and, with
gradient_as_bucket_view, point every .grad at a view of them, which fights
the views into the flat buffer here. With `fsdp > 1` the flat gradient is
reduce-scattered over the fsdp group and its slice all-reduced over the
data group; each rank updates its 1/fsdp slice of the flat parameters and
keeps only that slice of both moments (the optimizer state is sharded),
and the updated slices are all-gathered into every rank's flat buffer. The
parameters stay whole during compute, where the JAX package all-gathers
them at use; the numbers are the same. The flat buffers are then padded
with zeros to a multiple of fsdp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from benchmark.reference import constant
from benchmark.reference.config import Config
from benchmark.reference.parallel.mesh import Mesh

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

    def __init__(self, params: list[nn.Parameter], schedule: Callable, weight_decay: float = 0.0,
                 mesh: Mesh | None = None):
        if not params:
            raise ValueError("Adam: no parameter to train")
        dev = params[0].device
        n = sum(p.numel() for p in params)
        self.params = params
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.mesh = mesh
        self.n = n
        f = mesh.fsdp if mesh is not None else 1
        shard = -(-n // f)
        self.flat = torch.zeros(shard * f, dtype=torch.float32, device=dev)
        self.grad = torch.zeros_like(self.flat)
        # this rank's slice of the flat buffers, which its moments cover
        self.shard = slice(mesh.fsdp_rank * shard, (mesh.fsdp_rank + 1) * shard) if f > 1 else slice(0, n)
        self.mu = torch.zeros(shard, dtype=torch.float32, device=dev)
        self.nu = torch.zeros_like(self.mu)
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

    def _reduced_grad(self) -> torch.Tensor:
        """The global gradient of this rank's slice: the flat gradient
        summed over the ranks (one all-reduce; with fsdp a reduce-scatter
        over the fsdp group and an all-reduce over the data group)."""
        mesh = self.mesh
        if mesh is None or not mesh.distributed:
            return self.grad
        if mesh.fsdp == 1:
            dist.all_reduce(self.grad, group=mesh.group)
            return self.grad
        g = torch.empty_like(self.mu)
        dist.reduce_scatter_tensor(g, self.grad, group=mesh.fsdp_group)
        dist.all_reduce(g, group=mesh.data_group)
        return g

    @torch.no_grad()
    def step(self, ok: torch.Tensor) -> None:
        """Reduce the gradient over the ranks, then one update where the
        device bool `ok` holds, none where it does not. The gate selects
        (torch.where) and never multiplies, since the gradient of a skipped
        step may hold NaN and 0 * NaN is NaN."""
        g = self._reduced_grad()
        flat = self.flat[self.shard]
        mu = g.mul(1.0 - B1).add_(self.mu, alpha=B1)
        nu = g.square().mul_(1.0 - B2).add_(self.nu, alpha=B2)
        t = (self.count + 1).float()
        update = (mu / (1.0 - torch.pow(B1, t))) / ((nu / (1.0 - torch.pow(B2, t))).sqrt_().add_(EPS))
        if self.weight_decay:
            update.add_(flat, alpha=self.weight_decay)
        new = flat - self.schedule(self.count) * update
        torch.where(ok, mu, self.mu, out=self.mu)
        torch.where(ok, nu, self.nu, out=self.nu)
        if self.mesh is not None and self.mesh.fsdp > 1:
            dist.all_gather_into_tensor(self.flat, torch.where(ok, new, flat), group=self.mesh.fsdp_group)
        else:
            torch.where(ok, new, flat, out=flat)
        self.count.add_(ok.to(self.count.dtype))

    def full_moments(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Both moments over all n trained parameters; under fsdp an
        all-gather over the fsdp group, which every rank must join."""
        if self.mesh is None or self.mesh.fsdp == 1:
            return self.mu, self.nu
        out = []
        for m in (self.mu, self.nu):
            full = torch.empty_like(self.flat)
            dist.all_gather_into_tensor(full, m, group=self.mesh.fsdp_group)
            out.append(full[:self.n])
        return out[0], out[1]

    @torch.no_grad()
    def load_moments(self, mu: torch.Tensor, nu: torch.Tensor) -> None:
        """Take this rank's slice of moments over all n trained parameters."""
        for mine, full in ((self.mu, mu), (self.nu, nu)):
            padded = torch.zeros_like(self.flat)
            padded[:self.n] = full
            mine.copy_(padded[self.shard])


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
                       steps_per_epoch: int = 1000, mesh: Mesh | None = None) -> TrainState:
    """Adam (or AdamW) over the model's trained parameters. `sample_batch`
    is the JAX signature's init batch: the port's model already holds its
    weights (build_model, or a converted state dict), so it is not read.
    A converted imagenet encoder npz, when `encoder_npz_for(config)` finds
    one, is copied into the model first, as the JAX package merges it into
    its fresh variables (reference res_encoder.py:349-353). Freezing
    follows the reference (utils/train_utils.py:205-240): only_train_regressor freezes the encoder, the light estimator and the
    albedo; only_train_texture the encoder and the hand heads' base, pose
    and shape layers; freeze_hm_estimator adds the heatmap branch. With a
    `mesh` the gradient is reduced over its ranks, and under fsdp the
    optimizer state is sharded (the module docstring)."""
    del sample_batch
    frozen: tuple[str, ...] = ()
    if config.only_train_regressor:
        frozen = ("encoder", "light_estimator", "hand_encoder/tex", "vert_tex")
    elif config.only_train_texture:
        frozen = ("encoder", "rgb2hm", "hand_encoder/base", "hand_encoder/pose",
                  "hand_encoder/shape")
    if config.freeze_hm_estimator:  # reference train_utils.py:206-208
        frozen = frozen + ("rgb2hm",)
    wd = ADAMW_WEIGHT_DECAY if config.optimizer == "AdamW" else 0.0
    opt = Adam(freeze_submodules(model, frozen), make_lr_schedule(config, steps_per_epoch), wd, mesh)
    return TrainState(model, opt)
