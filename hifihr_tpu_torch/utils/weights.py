"""Converted-weight loading and the degraded-asset report (counterpart of
hifihr_tpu/utils/weights.py), with the port's own asset directory,
hifihr_tpu_torch/assets/.

The reference depends on released binaries (torchvision imagenet encoders,
VGG19 perceptual weights, LPIPS AlexNet, the licensed NIMBLE release); both
packages take them as converted npz files and run a random-init or derived
stand-in where one is absent. `degraded_components(config)` lists which
components run so for a config, and the Trainer logs each at startup.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

import hifihr_tpu_torch.assets as _assets

ASSETS_DIR = os.path.dirname(os.path.abspath(_assets.__file__))


def asset_path(name: str) -> str:
    return os.path.join(ASSETS_DIR, name)


def _flax_entries(model: nn.Module) -> dict[str, list[tuple[str, str]]]:
    """(flax path, state-dict name) of every parameter and BatchNorm running
    stat, by flax collection, in the model's registration order. The port's
    module names are the flax paths, so a conv or dense `weight` is flax's
    `kernel`, a BatchNorm's `scale`, and its running mean and var are
    `batch_stats` `mean` and `var`."""
    out: dict[str, list[tuple[str, str]]] = {"params": [], "batch_stats": []}
    for module_name, m in model.named_modules():
        prefix = module_name.replace(".", "/") + "/" if module_name else ""
        norm = isinstance(m, nn.modules.batchnorm._BatchNorm)
        dot = module_name + "." if module_name else ""
        for leaf, _ in m.named_parameters(recurse=False):
            flax_leaf = ("scale" if norm else "kernel") if leaf == "weight" else leaf
            out["params"].append((prefix + flax_leaf, dot + leaf))
        if norm:
            out["batch_stats"].append((prefix + "mean", dot + "running_mean"))
            out["batch_stats"].append((prefix + "var", dot + "running_var"))
    return out


def _nest(path: str, value) -> dict:
    tree = value
    for part in reversed(path.split("/")):
        tree = {part: tree}
    return tree


def merge_npz_into_model(npz_path: str, model: nn.Module) -> int:
    """The counterpart of merge_npz_into_variables: copy a converted encoder
    npz (keys 'params/...', 'batch_stats/...' in flax layout, as
    tools/convert_torch_weights.py writes them) into the model in place.

    Each key goes to the first parameter or running stat whose flax path ends
    with the key's path, and is copied there when its flax shape matches
    (converted by `convert.state_dict_from_flax`, the s2d stems included);
    otherwise that entry keeps its value. Returns the number copied. Call it
    before the optimizer's state exists, or copy into its views, as here."""
    from hifihr_tpu_torch.convert import state_dict_from_flax

    entries = _flax_entries(model)
    sd = model.state_dict(keep_vars=True)
    with np.load(npz_path) as z:
        flat = {k: z[k] for k in z.files}
    copied = 0
    with torch.no_grad():
        for key, arr in flat.items():
            kind, rest = key.split("/", 1)
            for path, name in entries[kind]:
                if path.endswith(rest):
                    if _flax_shape(name, sd[name], model) == arr.shape:
                        tree = _nest(path, arr)
                        variables = {"params": tree} if kind == "params" else {"params": {}, "batch_stats": tree}
                        sd[name].copy_(state_dict_from_flax(variables)[name])
                        copied += 1
                    break
    return copied


def _flax_shape(name: str, t: torch.Tensor, model: nn.Module) -> tuple:
    """The shape the JAX package keeps `name` in: conv kernels HWIO (the
    stems in s2d form), dense kernels (in, out), everything else as is."""
    from hifihr_tpu_torch.networks.resnet import StemConv

    module, _, leaf = name.rpartition(".")
    m = model.get_submodule(module) if module else model
    if leaf != "weight" or isinstance(m, nn.modules.batchnorm._BatchNorm):
        return tuple(t.shape)
    if isinstance(m, StemConv):
        o, c = t.shape[:2]
        return (m.taps, m.taps, 4 * c, o)
    if t.ndim == 4:
        return tuple(t.permute(2, 3, 1, 0).shape)
    return tuple(t.T.shape)


def encoder_npz_for(config) -> str | None:
    """The converted imagenet npz for the configured encoder: an explicit
    `config.encoder_imagenet_npz` wins (None when that file is missing),
    else assets/imagenet_<pretrain>.npz when it exists."""
    explicit = getattr(config, "encoder_imagenet_npz", None)
    if explicit:
        return explicit if os.path.exists(explicit) else None
    conventional = asset_path(f"imagenet_{config.pretrain}.npz")
    return conventional if os.path.exists(conventional) else None


def degraded_components(config) -> list[str]:
    """Which components run degraded (random init or a derived stand-in)
    for this config; an empty list is a full-fidelity run."""
    msgs = []
    if encoder_npz_for(config) is None:
        msgs.append(
            f"encoder '{config.pretrain}': RANDOM INIT — no converted imagenet "
            f"weights at {asset_path(f'imagenet_{config.pretrain}.npz')} "
            "(tools/convert_torch_weights.py "
            f"{config.pretrain} <torch.pth> <out.npz>); the reference trains "
            "from torchvision/timm imagenet weights (res_encoder.py:349-353)"
        )
    if "perceptual" in tuple(config.losses) and not os.path.exists(_assets.VGG_NPZ):
        msgs.append(
            "perceptual loss: VGG19 features are RANDOM INIT — convert with "
            f"tools/convert_torch_weights.py vgg <vgg19.pth> {_assets.VGG_NPZ} "
            "(reference perceptual_loss.py:28 uses torchvision vgg19 pretrained)"
        )
    if not os.path.exists(asset_path("lpips_alex.npz")):
        msgs.append(
            "LPIPS eval metric: AlexNet features are RANDOM INIT — reported "
            "as 'lpips_randinit' in eval output; convert with "
            "tools/convert_torch_weights.py lpips <alex.pth> <lin.pth> "
            + asset_path("lpips_alex.npz")
        )
    if config.hand_model == "nimble" and not os.path.exists(asset_path("nimble.npz")):
        msgs.append(
            "NIMBLE hand layer: running on DERIVED placeholder assets "
            "(tools/make_nimble_assets.py: edge-split MANO geometry, synthetic "
            "tex PCA) — convert the licensed NIMBLE release into "
            + asset_path("nimble.npz")
            + " for full fidelity"
        )
    return msgs
