"""Process groups, batch sharding and replication: the port's counterpart of
hifihr_tpu/parallel/mesh.py.

The JAX package trains SPMD over a `jax.sharding.Mesh`: one program over one
global batch whose leading dim shards over every mesh axis, so every
reduction over the batch (the loss terms, flax's BatchNorm statistics) is a
global one. The port runs one process per rank over `torch.distributed` and
keeps those semantics by hand:

  * `config.train_batch` is the global batch; each rank takes its
    1/world of the rows (`Mesh.rows`, `Mesh.shard_batch`), in rank order,
    as JAX's batch sharding P(('data', 'fsdp')) orders its shards;
  * BatchNorm in train mode all-reduces its per-channel sums
    (networks/batchnorm.py), the loss stack returns per-rank shares of the
    global terms (losses/stack.py), the skip guard decides on the global
    total (training/steps.py) and the flat gradient is summed over the
    ranks (training/train_state.py);
  * two layouts, as in the JAX package: 1-D ('data',), and 2-D ('data',
    'fsdp') when `fsdp > 1`, where rank r sits at (r // fsdp, r % fsdp) of
    a (world / fsdp, fsdp) grid: the fsdp group holds the ranks of one
    row, the data group those of one column.

`init_distributed(backend)` starts the process group from torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK); the backend is always the
caller's choice. With no process group, `make_mesh` gives the one-rank mesh,
which runs no collective at all. On a mesh with a process group every
collective runs, also where a group has a single member; the one exception
is BatchNorm over a batch group of one rank, which keeps its
`native_batch_norm` path. The port calls only `all_reduce` and `broadcast`
on the batch and data groups, the two collectives gloo carries for CUDA
tensors; `fsdp > 1` also reduce-scatters and all-gathers over the fsdp
group, which takes NCCL on the card (or gloo on the CPU).
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from hifihr_tpu_torch import resolve_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TIMEOUT = timedelta(minutes=10)  # of every collective, unless the caller gives one


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the run. `group` spans every rank (the batch
    shards over it); `data_group` and `fsdp_group` are the column and row of
    the (world / fsdp, fsdp) grid that hold this rank. All three are None
    on the one-rank mesh that has no process group."""

    device: torch.device
    rank: int = 0
    world: int = 1
    fsdp: int = 1
    group: object = None
    data_group: object = None
    fsdp_group: object = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def fsdp_rank(self) -> int:
        return self.rank % self.fsdp

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of n."""
        if n % self.world:
            raise ValueError(f"a batch of {n} rows does not split over {self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of every array (numpy or torch) in `batch`;
        strings (the `dataset` tag) pass through."""
        n = next(len(v) for v in batch.values() if not isinstance(v, str) and np.ndim(v))
        rows = self.rows(n)
        return {k: v if isinstance(v, str) or not np.ndim(v) else v[rows] for k, v in batch.items()}

    def barrier(self) -> None:
        """Every rank waits here for the others: an all-reduce of one number
        on this rank's device, read back."""
        if self.distributed:
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t, group=self.group)
            t.item()


def init_distributed(backend: str = "nccl", device=None, init_method: str = "env://",
                     timeout: timedelta = TIMEOUT) -> torch.device:
    """Start the default process group from torchrun's RANK and WORLD_SIZE
    under `backend` ('nccl', or 'gloo' for ranks that share a card or run
    on the CPU), and return this rank's device: `device` when given (e.g.
    'cpu'), else cuda:LOCAL_RANK % device_count."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is None:
        resolve_device("cuda")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, timeout=timeout)
    return device


def make_mesh(fsdp: int = 1, device=None, timeout: timedelta | None = None) -> Mesh:
    """The mesh of the current process group (every rank must call this,
    in the same order), or the one-rank mesh when there is none. `fsdp`
    must divide the world size."""
    device = resolve_device(device)
    if not dist.is_initialized():
        if fsdp != 1:
            raise ValueError(f"fsdp={fsdp} needs a process group whose world size it divides")
        return Mesh(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if fsdp < 1 or world % fsdp:
        raise ValueError(f"fsdp={fsdp} does not divide the world size {world}")
    group = dist.group.WORLD
    if fsdp == 1:
        return Mesh(device, rank, world, 1, group, group, None)
    timeout = timeout or TIMEOUT
    data_group = fsdp_group = None
    for d in range(world // fsdp):  # rows: one fsdp group each
        g = dist.new_group([d * fsdp + j for j in range(fsdp)], timeout=timeout)
        if rank // fsdp == d:
            fsdp_group = g
    for j in range(fsdp):  # columns: one data group each
        g = dist.new_group([d * fsdp + j for d in range(world // fsdp)], timeout=timeout)
        if rank % fsdp == j:
            data_group = g
    return Mesh(device, rank, world, fsdp, group, data_group, fsdp_group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks, whose gradient is the sum over the ranks
    of the gradients (each rank's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable."""
    return _AllReduceSum.apply(x, group)


def replicate(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Place the model on the mesh: its parameters and buffers broadcast
    from rank 0, and every flax-semantics BatchNorm told which ranks share
    its batch (none at one rank, where it keeps its native path). The
    optimizer shards its own state (training/train_state.py). A no-op on the
    one-rank mesh without a process group."""
    from hifihr_tpu_torch.networks.batchnorm import FlaxBatchNorm

    if not mesh.distributed:
        return model
    with torch.no_grad():
        for t in itertools.chain(model.parameters(), model.buffers()):
            buf = t.data if t.data.is_contiguous() else t.data.contiguous()
            dist.broadcast(buf, src=0, group=mesh.group)
            if buf is not t.data:
                t.data.copy_(buf)
    group = mesh.group if mesh.world > 1 else None
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm):
            m.batch_group = group
    return model
