"""The DART branch of the port against the JAX package (CPU, fp32):
`attach_j2d` for both of its branches, and one train step with
dat_name="Dart" on a DART-schema batch (`imgs`, `ortho_intr`, `joints`,
`j2d_gt`, `verts`, `root_xyz` and no `Ks`, as hifihr_tpu/data/dart.py
emits it), from the same converted weights.

Tolerances: the projections at rtol 1e-6 (the same fp32 formulas); the
train step as tests/test_torch_train_slice.py holds the flagship's: batch
8 (the heads' train-mode BatchNorm is ill-conditioned at batch 2), every
loss term and `total` within 1e-4 relative after one step, every gradient
within 1e-3 relative L2. The configuration is the loader integration test's
(tests/test_dataset_train_integration.py): res18, MANO, no render, 32 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.losses.stack import LossComputer as JLossComputer
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.models.hifihr import attach_j2d as jattach_j2d
from hifihr_tpu.training.steps import make_sched as jmake_sched
from hifihr_tpu.training.steps import make_train_step as jmake_train_step
from hifihr_tpu.training.train_state import TrainState as JTrainState
from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.geometry.projection import orthographic_project
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.models.hifihr import HiFiHR, attach_j2d
from hifihr_tpu_torch.training.steps import make_sched, make_train_step
from hifihr_tpu_torch.training.train_state import create_train_state
from torch_port_helpers import fake_K, randomize_variables, rel_l2

B, S = 8, 32
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mpose", "mshape")
CFG = dict(pretrain="res18", hand_model="mano", render=False, light_estimation=False, image_size=S,
           compute_dtype="float32", losses=LOSSES, init_lr=1e-3)
ZERO_GRAD_BIASES = {"hand_encoder.base_fc0.bias": "hand_encoder.base_fc0.weight",
                    "hand_encoder.base_fc1.bias": "hand_encoder.base_fc1.weight"}


def _projection_inputs(seed: int = 0) -> dict:
    """Seeded root-relative joints (21, and NIMBLE's 25), intrinsics, roots
    and fitted orthographic cameras [s, tu, tv] at DART's scale."""
    rng = np.random.RandomState(seed)
    return {
        "joints": (rng.randn(B, 21, 3) * 0.03).astype(np.float32),
        "nimble_joints": (rng.randn(B, 25, 3) * 0.03).astype(np.float32),
        "Ks": fake_K(B, S),
        "root_xyz": (rng.randn(B, 1, 3) * 0.02 + [0, 0, 0.5]).astype(np.float32),
        "ortho_intr": np.stack([rng.uniform(300, 700, B), rng.uniform(100, 150, B),
                                rng.uniform(100, 150, B)], axis=-1).astype(np.float32),
    }


@pytest.mark.parametrize("with_nimble", [False, True])
@pytest.mark.parametrize("dat_name", ["Dart", "FreiHand"])
def test_attach_j2d_matches_jax(dat_name, with_nimble):
    x = _projection_inputs()
    keys = ("joints", "nimble_joints") if with_nimble else ("joints",)
    ref = jattach_j2d({k: jnp.asarray(x[k]) for k in keys}, Ks=jnp.asarray(x["Ks"]),
                      root_xyz=jnp.asarray(x["root_xyz"]), ortho_intr=jnp.asarray(x["ortho_intr"]),
                      dat_name=dat_name)
    out = attach_j2d({k: torch.tensor(x[k]) for k in keys}, Ks=torch.tensor(x["Ks"]),
                     root_xyz=torch.tensor(x["root_xyz"]), ortho_intr=torch.tensor(x["ortho_intr"]),
                     dat_name=dat_name)
    made = ("j2d", "nimble_j2d") if with_nimble else ("j2d",)
    assert set(out) == set(ref) == set(keys) | set(made)
    for k in made:
        assert tuple(out[k].shape) == (B, x[k.replace("j2d", "joints")].shape[1], 2)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, err_msg=k)


def test_orthographic_project_formula():
    """u = s x + tu, v = s y + tv; z is dropped."""
    x = _projection_inputs(1)
    j, cam = x["joints"], x["ortho_intr"]
    uv = orthographic_project(torch.tensor(j), torch.tensor(cam)).numpy()
    np.testing.assert_allclose(uv[..., 0], cam[:, :1] * j[..., 0] + cam[:, 1:2], rtol=1e-6)
    np.testing.assert_allclose(uv[..., 1], cam[:, :1] * j[..., 1] + cam[:, 2:3], rtol=1e-6)


def _dart_batch() -> dict:
    """A DART-schema batch (hifihr_tpu/data/dart.py): camera-space targets
    with the root at joint 9, 2D targets in the image's pixels, a fitted
    orthographic camera, and no Ks."""
    rng = np.random.RandomState(0)
    joints = (rng.randn(B, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32)
    cam = np.stack([rng.uniform(40, 60, B), rng.uniform(14, 18, B), rng.uniform(14, 18, B)],
                   axis=-1).astype(np.float32)
    return {
        "imgs": rng.rand(B, S, S, 3).astype(np.float32),
        "ortho_intr": cam,
        "joints": joints,
        "j2d_gt": (rng.rand(B, 21, 2) * S).astype(np.float32),
        "verts": (rng.randn(B, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "root_xyz": joints[:, 9:10].copy(),
    }


@pytest.fixture(scope="module")
def dart_runs():
    """One train step of each package from the same weights on the DART
    batch: the loss dict and every parameter's gradient (JAX's read back
    from Adam's first moment, mu = (1 - b1) g)."""
    batch = _dart_batch()
    assert "Ks" not in batch
    jcfg = JConfig(**CFG)
    jm = JModel(config=jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b["imgs"], None, b["root_xyz"], train=False))(jb)
    v = randomize_variables(v, seed=0)
    state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=jmake_optimizer(jcfg, 1000),
                               batch_stats=v["batch_stats"])
    state, d = jmake_train_step(jm, JLossComputer(jcfg), "Dart", jcfg)(state, jb, jmake_sched(jcfg, 0))
    jax_run = {"loss": {k: float(x) for k, x in d.items()},
               "grads": state_dict_from_flax({"params": jax.tree_util.tree_map(
                   lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)})}

    cfg = Config(**CFG)
    model = HiFiHR(cfg)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    tstate = create_train_state(model, cfg)
    tstep = make_train_step(model, LossComputer(cfg), "Dart", cfg)
    _, td = tstep(tstate, {k: torch.tensor(x) for k, x in batch.items()}, make_sched(cfg, 0, device="cpu"))
    port_run = {"loss": {k: float(x) for k, x in td.items()},
                "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
    return jax_run, port_run


def test_dart_train_step_loss_terms(dart_runs):
    jax_run, port_run = dart_runs
    assert set(port_run["loss"]) == set(jax_run["loss"]) == set(LOSSES) | {"total", "skipped"}
    assert port_run["loss"]["skipped"] == jax_run["loss"]["skipped"] == 0.0
    for k in LOSSES + ("total",):
        np.testing.assert_allclose(port_run["loss"][k], jax_run["loss"][k], rtol=1e-4, err_msg=k)


def test_dart_train_step_gradients(dart_runs):
    jax_run, port_run = dart_runs
    jg, tg = jax_run["grads"], port_run["grads"]
    assert set(jg) == set(tg)
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        if name in ZERO_GRAD_BIASES:
            scale = np.linalg.norm(jg[ZERO_GRAD_BIASES[name]].numpy())
            assert np.linalg.norm(a) < 1e-6 * scale and np.linalg.norm(b) < 1e-6 * scale, name
        elif not b.any():  # outputs no loss reads
            assert not a.any(), name
        else:
            assert rel_l2(a, b) < 1e-3, (name, rel_l2(a, b))
