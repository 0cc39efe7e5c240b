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
