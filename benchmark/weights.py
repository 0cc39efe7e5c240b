"""Seeded weights, made on the device by the benchmark and loaded into the
port's model and into the reference alike.

The distributions are those of the port's `init_weights` (flax's
initialisers): truncated-normal lecun for convs, variance scaling over
fan_out for the s2d stems, He-normal for dense layers with the hand heads'
output layers scaled by HEAD_OUT_SCALE, zero biases, unit BatchNorm scales
with running statistics (0, 1), zero MMPool mix and vertex albedo. They are
drawn from one `torch.Generator` on the device in two calls over one flat
buffer each (truncated and plain normals), in the order of
`named_modules`, which the port and the reference share; the rules key on
class and parameter names, so one function serves both models.
"""

from __future__ import annotations

import torch
from torch import nn

HEAD_OUT_SCALE = 1e-3  # models/hifihr.py: random heads predict a hand near the mean
TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def _draws(model: nn.Module) -> tuple[list, list]:
    """(truncated, plain): lists of (parameter, std) for every weight drawn."""
    trunc, plain = [], []
    for name, m in model.named_modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            continue
        if type(m).__name__ == "StemConv":
            trunc.append((m.weight, (2.0 / (m.taps ** 2 * m.weight.shape[0])) ** 0.5))
        elif isinstance(m, nn.Conv2d):
            trunc.append((m.weight, (1.0 / m.weight[0].numel()) ** 0.5))
        elif isinstance(m, nn.Linear):
            scale = HEAD_OUT_SCALE if name.startswith("hand_encoder.") and name.endswith("_out") else 1.0
            plain.append((m.weight, (2.0 / m.weight.shape[1]) ** 0.5 * scale))
    return trunc, plain


@torch.no_grad()
def load_seeded_weights(model: nn.Module, seed: int, device) -> None:
    """Overwrite every parameter and BatchNorm buffer of `model` (already on
    `device`) with the draws of `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
        elif isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
            m.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("mmpool.p") or name == "vert_tex":
            p.zero_()
    trunc, plain = _draws(model)
    for group, truncated in ((trunc, True), (plain, False)):
        n = sum(p.numel() for p, _ in group)
        if not n:
            continue
        flat = torch.empty(n, dtype=torch.float32, device=device)
        if truncated:
            torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
        else:
            flat.normal_(generator=gen)
        off = 0
        for p, std in group:
            k = p.numel()
            draw = flat[off:off + k].view(p.shape)
            p.copy_(draw * (std / TRUNC_STD if truncated else std))
            off += k
