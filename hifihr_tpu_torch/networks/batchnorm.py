"""BatchNorm with the semantics of flax.linen.BatchNorm(momentum=0.9), which
the JAX package's ResNet and hand heads use.

Eval mode normalises with the running statistics, as torch's BatchNorm does.
Train mode normalises with the batch statistics, reduced in fp32 whatever the
input's dtype (bf16 under autocast), and then updates the running statistics
as flax does:

  running_mean = 0.9 * running_mean + 0.1 * batch_mean
  running_var  = 0.9 * running_var  + 0.1 * batch_var   (the BIASED variance)

torch's own BatchNorm stores the unbiased variance, which differs by
B / (B - 1) per update (2x at batch 2). The batch statistics come from
`torch.native_batch_norm`, the kernel that also normalises: its saved
inverse std gives the biased variance as invstd^-2 - eps, with no extra pass
over the activations. State-dict names are torch's (weight, bias,
running_mean, running_var, num_batches_tracked).
"""

from __future__ import annotations

import torch
from torch import nn

MOMENTUM = 0.9  # flax's decay of the running statistics
EPS = 1e-5


class _FlaxStats:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        out, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                    True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.reciprocal().square_().sub_(self.eps)
            self.running_mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)
        return out


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=EPS)


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=EPS)
