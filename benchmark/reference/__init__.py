"""The benchmark's plain fp32 reference of the HiFiHR model, loss stack and
Adam step: a frozen copy of the port's plain PyTorch versions, with every
hand-written kernel replaced by plain PyTorch on whatever device it runs.

It imports nothing of `hifihr_tpu_torch` (nor JAX), so a later change to the
port cannot move it; the asset files are read by path with numpy. The
module layout follows the port's (geometry/, hand/, networks/, render/,
losses/, models/, training/), so its parameter names are the port's.

The check takes a configuration's reference by these six names at package
level (benchmark/spec.py, REFERENCE_ENTRY_POINTS): `Config`, `build_model`,
`LossComputer`, `make_train_step`, `make_sched`, `create_train_state`. A
configuration that needs what this one does not render or build names a
package of its own beside it (its file's "reference" key), which imports
the unchanged parts from here and overrides what it adds.
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


# the entry points, imported last: their modules import the helpers above
from benchmark.reference.config import Config  # noqa: E402
from benchmark.reference.losses.stack import LossComputer  # noqa: E402
from benchmark.reference.models.hifihr import build_model  # noqa: E402
from benchmark.reference.training.steps import make_sched, make_train_step  # noqa: E402
from benchmark.reference.training.train_state import create_train_state  # noqa: E402

__all__ = ["Config", "LossComputer", "build_model", "constant", "create_train_state", "make_sched",
           "make_train_step", "resolve_device", "variance_scaling_"]
