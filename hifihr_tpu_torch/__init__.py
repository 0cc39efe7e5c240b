"""PyTorch + CUDA port of hifihr_tpu for NVIDIA Hopper (H100).

Mirrors the layout of the JAX package (geometry/, hand/, networks/, render/,
models/, training/) and imports nothing from it, nor JAX. The Pallas TPU
kernels on the ported path are hand-written CUDA kernels under csrc/, built
at first use by `kernels.py`; each has a plain PyTorch version beside it in
the same module, which the wrapper takes for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict = {}


def constant(values, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(values, dtype=dtype)` on `device`, made once and
    cached by content: a host-to-device copy makes the host wait for the
    card, so the train and eval steps copy each small constant (an index
    list, a colour) only on their first call."""
    a = np.asarray(values)
    key = (a.tobytes(), a.dtype.str, a.shape, torch.device(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        # a normal tensor even when first made under the eval step's
        # inference_mode, so the train step's autograd can save it
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return t


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hifihr_tpu_torch: CUDA requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run the plain versions")
    return dev
