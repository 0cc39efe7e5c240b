"""Checkpoint save and restore with selective-submodule semantics
(counterpart of hifihr_tpu/training/checkpoint.py, on torch.save).

A checkpoint `<dir>/texturehand_{tag}.pt` holds the model's state dict
(parameters and BatchNorm running stats), the Adam state (both moments, the
count, and the names and shapes of the trained parameters they are laid out
over) and the epoch. `restore` intersects the stored state dict with the
model's by name and shape, so a checkpoint of a render=False run warm-starts
a render=True model (what is missing keeps its fresh init); the Adam state
is restored only where the trained-parameter layout matches, otherwise the
weights alone, like the reference's partial loads
(utils/train_utils.py:14-202). `save_mode` mirrors the reference:
'only_latest', or 'separately', which keeps every 20th epoch.

The trained parameters are views into Adam's flat buffer
(training/train_state.py), so a restore copies into them in place; it never
rebinds a parameter.

`load_flax_export` reads a JAX package checkpoint, exported to an npz by
tools/export_flax_checkpoint.py (the port does not import orbax or JAX):
the parameters and BatchNorm statistics through
`convert.state_dict_from_flax`, Adam's moments into the flat buffer, its
count and the epoch.

Over several ranks every rank calls `save`: under fsdp the moments are
first gathered over the fsdp group, so a checkpoint holds them whole and
loads at any world size and any fsdp; rank 0 alone writes, and the others
wait for it at a barrier. Every rank restores, taking its own slice of the
moments.
"""

from __future__ import annotations

import os

import torch

from hifihr_tpu_torch.training.train_state import TrainState

_PREFIX = "texturehand_"


def _layout(state: TrainState) -> list:
    """[name, shape] of each trained parameter, in the flat buffer's order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [[names[id(p)], list(p.shape)] for p in state.optimizer.params]


class CheckpointManager:
    def __init__(self, directory: str, save_mode: str = "separately"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_mode = save_mode

    def _path(self, tag) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{tag}.pt")

    def save(self, state: TrainState, epoch: int) -> str:
        opt = state.optimizer
        mu, nu = opt.full_moments()
        tags = ["latest"] if self.save_mode == "only_latest" else [str(epoch), "latest"]
        mesh = opt.mesh
        if mesh is not None and mesh.rank != 0:
            mesh.barrier()
            return self._path(tags[0])
        payload = {
            "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "optimizer": {"mu": mu.cpu(), "nu": nu.cpu(), "count": opt.count.cpu(),
                          "layout": _layout(state)},
            "epoch": int(epoch),
        }
        try:
            self._write(payload, tags, epoch)
        finally:  # the other ranks wait for this write, whatever its outcome
            if mesh is not None:
                mesh.barrier()
        return self._path(tags[0])

    def _write(self, payload: dict, tags: list, epoch: int) -> None:
        for tag in tags:
            path = self._path(tag)
            torch.save(payload, path + ".tmp")
            os.replace(path + ".tmp", path)  # a reader never sees half a file
        # prune non-snapshot epochs (keep every 20th, reference
        # train_utils.py:185-199)
        if self.save_mode == "separately":
            for name in os.listdir(self.directory):
                if not (name.startswith(_PREFIX) and name.endswith(".pt")):
                    continue
                try:
                    e = int(name[len(_PREFIX):-len(".pt")])
                except ValueError:  # 'latest'
                    continue
                if e != epoch and e % 20 != 0:
                    os.remove(os.path.join(self.directory, name))

    def _load(self, tag, device) -> dict:
        return torch.load(self._path(tag), map_location=device, weights_only=True)

    @torch.no_grad()
    def restore_submodules(self, state: TrainState, prefixes: tuple, tag="latest") -> TrainState:
        """Load only the parameters and running stats whose '/'-joined name
        starts with a prefix (e.g. ('rgb2hm',) or ('hand_encoder/tex',)):
        the reference's module-targeted warm starts
        (utils/train_utils.py:96-111)."""
        stored = self._load(tag, state.optimizer.flat.device)["model"]
        for name, t in state.model.state_dict().items():
            if any(name.replace(".", "/").startswith(p) for p in prefixes) and name in stored \
                    and stored[name].shape == t.shape:
                t.copy_(stored[name])
        return state

    @torch.no_grad()
    def restore(self, state: TrainState, tag="latest") -> tuple[TrainState, int]:
        """Returns (state, epoch), the state restored in place: every entry
        of the model's state dict that the file holds with the same shape,
        and the Adam state where the trained-parameter layout matches."""
        stored = self._load(tag, state.optimizer.flat.device)
        model = stored["model"]
        for name, t in state.model.state_dict().items():
            if name in model and model[name].shape == t.shape:
                t.copy_(model[name])
        opt, saved = state.optimizer, stored["optimizer"]
        if saved["layout"] == _layout(state):
            opt.load_moments(saved["mu"], saved["nu"])
            opt.count.copy_(saved["count"])
        return state, int(stored.get("epoch", 0))


def _nested(flat: dict, prefix: str) -> dict:
    """The keys '<prefix>/a/b/...' of an export as a nested dict."""
    tree: dict = {}
    for key, a in flat.items():
        if key.startswith(prefix + "/"):
            *parents, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = a
    return tree


@torch.no_grad()
def load_flax_export(npz_path: str, state: TrainState) -> tuple[TrainState, int]:
    """A JAX checkpoint's export (tools/export_flax_checkpoint.py) into
    `state` in place; returns (state, epoch). Every parameter and running
    statistic of the export is copied into the model (all of the model's
    must be there); Adam's moments, laid out over the trained parameters
    in the flat buffer's order and strides, and its count are loaded; the
    export must hold moments for exactly the trained parameters, as optax
    keeps none for the ones multi_transform freezes."""
    import numpy as np

    from hifihr_tpu_torch.convert import state_dict_from_flax

    with np.load(npz_path) as z:
        flat = {k: z[k] for k in z.files}
    sd = state_dict_from_flax({"params": _nested(flat, "params"), "batch_stats": _nested(flat, "batch_stats")})
    model_sd = state.model.state_dict()
    missing = sorted(set(model_sd) - set(sd))
    if missing:
        raise KeyError(f"the export lacks {len(missing)} of the model's tensors, e.g. {missing[:3]}")
    for name, t in model_sd.items():
        t.copy_(sd[name])
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    trained = [names[id(p)] for p in opt.params]
    moments = []
    for kind in ("mu", "nu"):
        m = state_dict_from_flax({"params": _nested(flat, kind)})
        if set(m) != set(trained):
            raise KeyError(f"the export's {kind} covers {len(m)} parameters, the state trains {len(trained)}")
        full = torch.zeros(opt.n, dtype=torch.float32, device=opt.flat.device)
        for p, name in zip(opt.params, trained):
            full.as_strided(p.shape, p.stride(), p.storage_offset()).copy_(m[name])
        moments.append(full)
    opt.load_moments(*moments)
    opt.count.fill_(int(flat["count"]))
    return state, int(flat["epoch"])
