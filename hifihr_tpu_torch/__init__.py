"""PyTorch + CUDA port of hifihr_tpu for NVIDIA Hopper (H100).

Mirrors the layout of the JAX package (geometry/, hand/, networks/, render/,
models/, training/) and imports nothing from it, nor JAX. The Pallas TPU
kernels on the ported path are hand-written CUDA kernels under csrc/, built
at first use by `kernels.py`; each has a plain PyTorch version beside it in
the same module, which the wrapper takes for CPU tensors.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hifihr_tpu_torch: CUDA requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run the plain versions")
    return dev
