"""BatchNorm with the semantics of flax.linen.BatchNorm: momentum 0.9 and eps
1e-5 for the JAX package's ResNet and hand heads (the defaults here), 0.99
and 1e-3 for its EfficientNet.

Eval mode normalises with the running statistics, as torch's BatchNorm does.
Train mode normalises with the batch statistics, reduced in fp32 whatever the
input's dtype (bf16 under autocast), and then updates the running statistics
as flax does:

  running_mean = m * running_mean + (1 - m) * batch_mean
  running_var  = m * running_var  + (1 - m) * batch_var   (the BIASED variance)

torch's own BatchNorm stores the unbiased variance, which differs by
B / (B - 1) per update (2x at batch 2). The batch statistics come from
`torch.native_batch_norm`, the kernel that also normalises: its saved
inverse std gives the biased variance as invstd^-2 - eps, with no extra pass
over the activations. State-dict names are torch's (weight, bias,
running_mean, running_var, num_batches_tracked).

Over several ranks (`batch_group`, set by parallel/mesh.py::replicate) the
statistics are the global batch's, as flax computes them under jit over a
sharded batch: the fp32 per-channel sums of x and x^2 and the row count are
all-reduced in one differentiable collective, so the gradient carries the
other ranks' terms (its backward all-reduces the gradients of the sums),
and the batch is normalised with mean = sum x / n and flax's variance
max(0, sum x^2 / n - mean^2). torch.nn.SyncBatchNorm is not this: it keeps
torch's momentum and unbiased running variance, and refuses CPU tensors.
At one rank the native path above runs, bit for bit as before.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.parallel.mesh import all_reduce_sum

MOMENTUM = 0.9  # flax's decay of the running statistics
EPS = 1e-5


class FlaxBatchNorm:
    """The train-mode forward of BatchNorm1d and BatchNorm2d below."""

    batch_group = None  # the process group whose ranks share the batch; None at one rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if self.batch_group is not None:
            return self._global_forward(x)
        out, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None,
                                                    True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.reciprocal().square_().sub_(self.eps)
            self._update_running(mean, var)
        return out

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(self.decay).add_(mean, alpha=1.0 - self.decay)
        self.running_var.mul_(self.decay).add_(var, alpha=1.0 - self.decay)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = [1, c] + [1] * (x.dim() - 2)
        xf = x.float()
        local = torch.cat([xf.sum(dims), (xf * xf).sum(dims), xf.new_full((1,), x.numel() // c)])
        stats = all_reduce_sum(local, self.batch_group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self._update_running(mean.detach(), var.detach())
        return out.to(x.dtype)


class BatchNorm1d(FlaxBatchNorm, nn.BatchNorm1d):
    def __init__(self, num_features: int, momentum: float = MOMENTUM, eps: float = EPS):
        super().__init__(num_features, eps=eps)
        self.decay = momentum  # flax's meaning; torch's `momentum` is 1 - decay and unused here


class BatchNorm2d(FlaxBatchNorm, nn.BatchNorm2d):
    def __init__(self, num_features: int, momentum: float = MOMENTUM, eps: float = EPS):
        super().__init__(num_features, eps=eps)
        self.decay = momentum
