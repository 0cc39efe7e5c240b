"""The closed loops a traffic file can name (`loop`), each over a pool of
distinct inputs made in set-up. Each is a pair in LOOPS: set-up's first
steps, whose record the check compares, and the window, which returns what
it did. The caller times set-up, and nothing here builds or compiles: every
shape was run before the window opens.

- train: train steps back to back over device-resident batches, with no
         synchronise inside the window except at its end.
"""

from __future__ import annotations

import time

import torch

FIRST_STEPS = 4  # the train steps of set-up; the reference follows the first three


def train_first_steps(program, pool: list) -> dict:
    """Set-up of a train cell: the program's first steps, through the
    window's own call, on pool batches 0..3 (all rows distinct). Keeps what
    the check compares: the flat parameters before step 1 and after step 3,
    the first moment after step 1, each step's total and the first step's
    loss terms."""
    opt = program.state.optimizer
    flat0 = opt.flat.clone()
    totals, mu1, flat3, terms1 = [], None, None, None
    for i in range(FIRST_STEPS):
        _, losses = program.step(program.state, pool[i % len(pool)], program.sched)
        totals.append(losses["total"])
        if i == 0:
            mu1 = opt.mu.clone()
            terms1 = {k: v for k, v in losses.items() if k not in ("total", "skipped")}
        if i == 2:
            flat3 = opt.flat.clone()
    if opt.flat.is_cuda:
        torch.cuda.synchronize()
    return {"flat0": flat0, "mu1": mu1, "flat3": flat3, "totals": torch.stack(totals[:3]).cpu(),
            "terms1": {k: float(v) for k, v in terms1.items()}}


def train_window(program, pool: list, seconds: float) -> dict:
    totals, skipped = [], []
    sync = torch.cuda.synchronize if program.state.optimizer.flat.is_cuda else (lambda: None)
    i = FIRST_STEPS
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _, losses = program.step(program.state, pool[i % len(pool)], program.sched)
        totals.append(losses["total"])
        skipped.append(losses["skipped"])
        i += 1
    sync()
    window = time.perf_counter() - t0
    totals, skipped = torch.stack(totals).cpu(), torch.stack(skipped).cpu()
    failed = int(((skipped > 0) | ~torch.isfinite(totals)).sum())
    batch = pool[0]["imgs"].shape[0]
    return {"window_s": window, "steps": len(totals), "images": len(totals) * batch,
            "attempted": len(totals), "failed": failed}


# loop name -> (set-up's first steps, the window)
LOOPS = {"train": (train_first_steps, train_window)}
