"""Run a function on N ranks of one host, each in a process of its own.

`spawn_ranks(target, world, ...)` starts `world` processes with the spawn
method; each sets torchrun's RANK, WORLD_SIZE and LOCAL_RANK, runs one
thread of intra-op work, starts the process group through
`mesh.init_distributed` on a file store (no TCP port, so concurrent runs on
one host never collide), calls `target(rank, world, device, *args)` and
saves its return value with torch.save. The parent waits for all of them
with one deadline, kills what is left at the deadline, and raises if any
rank failed, timed out or returned nothing: a hung rendezvous fails its
caller instead of blocking it. Returns the ranks' values in rank order.

`target` must be a module-level function (it is pickled by name) and its
value what torch.save and torch.load (weights_only) take: tensors on the
CPU, numbers, strings, lists and dicts.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from datetime import timedelta

import torch


def _rank_main(rank: int, world: int, backend: str, device: str | None, store: str, out_dir: str,
               collective_timeout_s: float, target, args: tuple) -> None:
    import torch.distributed as dist

    from hifihr_tpu_torch.parallel.mesh import init_distributed

    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        torch.set_num_threads(1)
        dev = init_distributed(backend, device=device, init_method=f"file://{store}",
                               timeout=timedelta(seconds=collective_timeout_s))
        try:
            value = target(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        torch.save(value, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(target, world: int, args: tuple = (), backend: str = "gloo", device: str | None = None,
                timeout_s: float = 300.0, collective_timeout_s: float = 120.0,
                workdir: str | None = None) -> list:
    """`target(rank, world, device, *args)` on `world` spawned ranks under
    `backend`; `device` is every rank's ('cpu', 'cuda:0' for ranks that
    share a card), or None for cuda:rank % device_count. Every collective
    times out after `collective_timeout_s`, the whole run after
    `timeout_s`."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, backend, device, store, tmp, collective_timeout_s, target, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif r in hung:
                errors.append(f"rank {r}: still running after {timeout_s} s; killed")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError(f"spawn_ranks({getattr(target, '__name__', target)}, world={world}) failed:\n"
                               + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True) for r in range(world)]
