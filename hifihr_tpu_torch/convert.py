"""Flax variables of hifihr_tpu's HiFiHR -> the port's state dict.

`state_dict_from_flax(variables)` takes the flax {"params", "batch_stats"}
tree as nested dicts of numpy arrays (no JAX needed here) and returns the
state dict of hifihr_tpu_torch.models.HiFiHR with the same configuration:

  conv kernel HWIO -> weight OIHW; Dense kernel (in, out) -> weight (out, in)
  BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  MMPool p and vert_tex as they are
  a depthwise kernel (k, k, 1, C) -> weight (C, 1, k, k), by the same rule
  the stems (ResNet's and EfficientNet's): the flax kernel is stored in
  space-to-depth form (hifihr_tpu/networks/resnet.py::StemConvS2D,
  (M, M, 12, O): (4, 4, 12, 64) for ResNet, (2, 2, 12, 40) for
  EfficientNet-b3); it is laid out again as the 2M x 2M / stride-2 kernel
  (O, 3, 2M, 2M) of hifihr_tpu_torch.networks.resnet.StemConv, which holds
  every s2d tap, so fresh and trained kernels both convert exactly. The
  rgb2hm hourglass's stem (`rgb2hm.stem_conv`: (4, 4, 12, 64) and a bias)
  converts by the same rule.

The LightEstimator flattens in NHWC order in both packages, so its fc0 rows
need no permutation. mano_new's heads (`beta_fc0/1`, `theta_fc0/1`, at the
top of the flax tree) map by the Dense rule to the model's modules of the
same names, and its ResNet-50 by the encoder's rules. The same function converts the perceptual loss's
VGG19 features ({"params": {"conv0": ..., ..., "conv5": ...}}) into the
state dict of hifihr_tpu_torch.losses.perceptual.VGG19Features.
"""

from __future__ import annotations

import numpy as np
import torch

# the s2d stems: an encoder's, alone or in the model, and the rgb2hm hourglass's
_STEMS = ("backbone.conv1", "backbone.conv_stem", "rgb2hm.stem_conv")


def stem_kernel_from_s2d(w2: np.ndarray) -> np.ndarray:
    """(M, M, 4C, O) space-to-depth kernel -> (2M, 2M, C, O) stride-2
    kernel: w[2m + d_i, 2n + d_j, c, o] = w2[m, n, (d_i, d_j, c), o], the
    s2d channel order of StemConvS2D's 2x2 patchify."""
    w2 = np.asarray(w2)
    M, _, c4, o = w2.shape
    w = w2.reshape(M, M, 2, 2, c4 // 4, o).transpose(0, 2, 1, 3, 4, 5)
    return w.reshape(2 * M, 2 * M, c4 // 4, o)


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items"):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


def state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for path, a in _leaves(variables["params"]):
        module, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            if module.endswith(_STEMS):
                a = stem_kernel_from_s2d(a)
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            sd[f"{module}.weight"] = torch.tensor(np.ascontiguousarray(a))
        elif leaf == "scale":
            sd[f"{module}.weight"] = torch.tensor(a)
        elif leaf in ("bias", "p", "vert_tex"):
            sd[path] = torch.tensor(a)
        else:
            raise KeyError(f"unmapped flax parameter {path}")
    for path, a in _leaves(variables.get("batch_stats", {})):
        module, _, leaf = path.rpartition(".")
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{module}.{name}"] = torch.tensor(a)
        sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return sd
