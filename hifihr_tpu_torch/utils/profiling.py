"""Profiling hooks (counterpart of hifihr_tpu/utils/profiling.py).

- `trace(log_dir)` wraps torch.profiler (CPU and, where there is one, CUDA
  activity) and writes a Chrome / TensorBoard trace
  (`<host>_<pid>.<time>.pt.trace.json`) into `log_dir` when the block ends.
- `StepTimer` counts images per second; `stop` synchronises the devices of
  the result's tensors before it stops the clock, so the time covers the
  work the card ran.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _cuda_devices(result) -> set:
    """The CUDA devices of every tensor in a (nested) result."""
    from torch.utils._pytree import tree_leaves

    return {t.device for t in tree_leaves(result) if torch.is_tensor(t) and t.is_cuda}


class StepTimer:
    def __init__(self):
        self.images = 0
        self.seconds = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result, n_images: int):
        """Waits for the devices of `result`'s tensors, so the time covers
        the work they ran."""
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        self.seconds += time.perf_counter() - self._t0
        self.images += n_images

    @property
    def images_per_sec(self) -> float:
        return self.images / self.seconds if self.seconds else 0.0
