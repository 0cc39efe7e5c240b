"""The benchmark's plain fp32 reference of the HiFiHR model, loss stack and
Adam step: a frozen copy of the port's plain PyTorch versions, with every
hand-written kernel replaced by plain PyTorch on whatever device it runs.

It imports nothing of `hifihr_tpu_torch` (nor JAX), so a later change to the
port cannot move it; the asset files are read by path with numpy. The
module layout follows the port's (geometry/, hand/, networks/, render/,
losses/, models/, training/), so its parameter names are the port's.
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
        raise RuntimeError("reference: CUDA requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run the plain versions")
    return dev


def variance_scaling_(w: torch.Tensor, scale: float, fan: int, gen: torch.Generator) -> torch.Tensor:
    """flax's variance_scaling(scale, mode, "truncated_normal") in place: a
    normal cut at 2 std, scaled to variance scale / fan (the caller picks
    fan_in or fan_out)."""
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_((scale / fan) ** 0.5 / 0.87962566103423978)
