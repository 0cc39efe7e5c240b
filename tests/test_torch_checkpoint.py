"""The port's checkpoints (hifihr_tpu_torch/training/checkpoint.py): the
round trip, the selective restores, and the 'separately' pruning against
the JAX package's CheckpointManager.

Tolerances: none; every restored tensor equals the saved one bit for bit,
and an entry a restore must not touch keeps its bits.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hifihr_tpu.training.checkpoint import CheckpointManager as JCheckpointManager
from hifihr_tpu.training.train_state import TrainState as JTrainState
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.models.hifihr import build_model
from hifihr_tpu_torch.training.checkpoint import CheckpointManager
from hifihr_tpu_torch.training.steps import make_sched, make_train_step
from hifihr_tpu_torch.training.train_state import create_train_state
from torch_port_helpers import fake_K

CFG = dict(pretrain="res18", hand_model="mano", render=False, light_estimation=False, image_size=32,
           compute_dtype="float32", losses=("joint_3d", "joint_2d", "mscale", "mpose"))


def _state(seed: int, steps: int = 0, **over):
    """A train state from build_model's seeded init after `steps` updates,
    so the moments, the count and the running stats are not their inits."""
    cfg = Config(**dict(CFG, **over))
    state = create_train_state(build_model(cfg, device="cpu", seed=seed), cfg)
    if steps:
        rng = np.random.RandomState(seed)
        batch = {"imgs": torch.tensor(rng.rand(4, 32, 32, 3), dtype=torch.float32),
                 "Ks": torch.tensor(fake_K(4, 32)), "root_xyz": torch.tensor([[[0.0, 0.0, 0.5]]]).repeat(4, 1, 1),
                 "joints": torch.tensor(rng.randn(4, 21, 3) * 0.03, dtype=torch.float32),
                 "j2d_gt": torch.tensor(rng.rand(4, 21, 2) * 32, dtype=torch.float32)}
        step = make_train_step(state.model, LossComputer(cfg), "FreiHand", cfg)
        for _ in range(steps):
            state, _ = step(state, batch, make_sched(cfg, 0, device="cpu"))
    return state


def _snapshot(state) -> dict:
    out = {f"model/{k}": v.clone() for k, v in state.model.state_dict().items()}
    opt = state.optimizer
    out.update({"opt/mu": opt.mu.clone(), "opt/nu": opt.nu.clone(), "opt/count": opt.count.clone()})
    return out


def test_round_trip_is_bit_equal(tmp_path):
    saved = _state(seed=0, steps=2)
    want = _snapshot(saved)
    assert int(saved.step) == 2 and saved.optimizer.nu.any()
    path = CheckpointManager(str(tmp_path / "ckpt"), "separately").save(saved, epoch=3)
    assert os.path.basename(path) == "texturehand_3.pt"
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["texturehand_3.pt", "texturehand_latest.pt"]

    fresh = _state(seed=1)
    flat = fresh.optimizer.flat
    restored, epoch = CheckpointManager(str(tmp_path / "ckpt"), "separately").restore(fresh)
    assert epoch == 3 and restored is fresh
    got = _snapshot(restored)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the parameters are still views of Adam's flat buffer: an update moves them
    p = next(restored.model.parameters())
    assert p.data_ptr() >= flat.data_ptr() and restored.optimizer.flat is flat
    flat.add_(1.0)
    assert torch.equal(p, want["model/" + next(n for n, _ in restored.model.named_parameters())] + 1.0)


def test_render_false_checkpoint_warm_starts_render_true(tmp_path):
    """The entries both models have come from the file; the render model's
    vert_tex keeps its fresh init, and Adam's state, laid out over other
    parameters, is not restored (weights only)."""
    src = _state(seed=0, steps=1)
    CheckpointManager(str(tmp_path), "only_latest").save(src, epoch=1)
    dst = _state(seed=1, render=True)
    vert_tex = dst.model.vert_tex.detach().clone()
    restored, epoch = CheckpointManager(str(tmp_path), "only_latest").restore(dst)
    assert epoch == 1
    stored = src.model.state_dict()
    for k, v in restored.model.state_dict().items():
        if k == "vert_tex":
            assert torch.equal(v, vert_tex)
        else:
            assert torch.equal(v, stored[k]), k
    assert int(restored.step) == 0 and not restored.optimizer.mu.any()


def test_restore_submodules_covers_only_its_prefixes(tmp_path):
    src = _state(seed=0, steps=1)
    CheckpointManager(str(tmp_path), "only_latest").save(src, epoch=0)
    dst = _state(seed=1)
    before = {k: v.clone() for k, v in dst.model.state_dict().items()}
    prefixes = ("hand_encoder/pose", "encoder/backbone/layer4_1")
    CheckpointManager(str(tmp_path), "only_latest").restore_submodules(dst, prefixes)
    stored = src.model.state_dict()
    hit = 0
    for k, v in dst.model.state_dict().items():
        if k.replace(".", "/").startswith(prefixes):
            assert torch.equal(v, stored[k]), k
            hit += 1
        else:
            assert torch.equal(v, before[k]), k
    assert hit >= 10 and int(dst.step) == 0


def test_separately_prunes_as_the_jax_package_does(tmp_path):
    """Saving epochs 0..41 keeps every 20th epoch, the last and 'latest',
    the same tags as the JAX package's manager keeps."""
    state = _state(seed=0)
    mine = CheckpointManager(str(tmp_path / "port"), "separately")
    ref = JCheckpointManager(str(tmp_path / "jax"), "separately")
    jstate = JTrainState.create(apply_fn=None, params={"w": jnp.zeros(2)}, tx=optax.adam(1e-3),
                                batch_stats={})
    for epoch in range(42):
        mine.save(state, epoch)
        if epoch % 20 in (0, 1) or epoch == 41:  # the JAX side at the epochs that decide the rule
            ref.save(jstate, epoch)
    tags = sorted(n[len("texturehand_"):-len(".pt")] for n in os.listdir(tmp_path / "port"))
    jtags = sorted(n[len("texturehand_"):] for n in os.listdir(tmp_path / "jax"))
    assert tags == jtags == ["0", "20", "40", "41", "latest"]


@pytest.mark.parametrize("mode", ["only_latest", "separately"])
def test_save_modes_write_their_tags(tmp_path, mode):
    state = _state(seed=0)
    CheckpointManager(str(tmp_path), mode).save(state, epoch=7)
    want = ["texturehand_latest.pt"] + (["texturehand_7.pt"] if mode == "separately" else [])
    assert sorted(os.listdir(tmp_path)) == sorted(want)
