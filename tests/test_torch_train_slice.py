"""The ported train step end to end: `make_train_step` of both packages from
the same converted weights on the same batch, in the slice tests' small
configuration (res18, 32 px, 3x3 MSAA, no light estimation, fp32) with the
flagship's loss set, Adam at lr 1e-3, batch 8.

Why batch 8 and not 2: the hand heads' BatchNorm1d over a batch of 2 has
channels whose two values differ by 1/3454 of their mean, and flax computes
the batch variance as E[x^2] - E[x]^2 in fp32, which loses every digit
there. Those channels also carry the largest backward gain, 1/sqrt(var +
eps). JAX's own jitted and op-by-op steps then differ by 4.7e-3 in the pose
parameters and the encoder gradients of the two packages by 4.5%. At batch 8
the statistics are well conditioned (ROADMAP.md section 3).

The JAX step is jitted, with its MSAA face selection run op by op through a
host callback (torch_port_helpers.jax_msaa_select_op_by_op), so no face id
hangs on XLA's multiply-add contraction. JAX's gradient is read back from
Adam's first moment after one step, mu = (1 - b1) g.

Tolerances:
- every fired loss term and `total` after one step: 1e-4 relative
  (measured 8e-6);
- every parameter's gradient: 1e-3 relative L2 error (measured 5e-4 at
  most, mmpool.p; the encoder 9e-5). A Linear bias that feeds a train-mode
  BatchNorm (the heads' base_fc0/base_fc1) has zero gradient in exact
  arithmetic, since the BatchNorm subtracts the batch mean; both packages
  give rounding noise there, held under 1e-6 of the layer's weight
  gradient;
- the BatchNorm running stats after one step: 1e-5 (measured 2.1e-6);
- the trajectory's `total`: steps 1-2 within 1e-4 relative; steps 3-5
  within 10% (measured 7e-8, 5e-5, 1.2e-3, 3.7e-2, 6.1e-2). From step 3
  the run is chaotic: JAX against itself, with its input images moved by
  one ulp, differs by 3.6e-3 at step 3 and 4.1% at step 5. Adam's first updates are about lr * sign(g), so gradient entries
  at the rounding level switch sign between any two runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.losses.stack import LossComputer as JLossComputer
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.render.renderer import PhongRenderer as JRenderer
from hifihr_tpu.training.steps import make_sched as jmake_sched
from hifihr_tpu.training.steps import make_train_step as jmake_train_step
from hifihr_tpu.training.train_state import TrainState as JTrainState
from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.models.hifihr import HiFiHR
from hifihr_tpu_torch.training.steps import make_sched, make_train_step
from hifihr_tpu_torch.training.train_state import create_train_state
from torch_port_helpers import fake_K, jax_msaa_select_op_by_op, randomize_variables, rel_l2

B, S, STEPS = 8, 32, 5
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "iou",
          "bone_direc")  # bench.py:46-49
CFG = dict(pretrain="res18", hand_model="mano", render=True, light_estimation=False, image_size=S,
           aa_factor=3, aa_mode="msaa", compute_dtype="float32", losses=LOSSES, init_lr=1e-3)
FIRED = LOSSES + ("texture_self", "mrgb_self", "ssim_tex_self", "texture", "mrgb", "ssim_tex", "total")
ZERO_GRAD_BIASES = {"hand_encoder.base_fc0.bias": "hand_encoder.base_fc0.weight",
                    "hand_encoder.base_fc1.bias": "hand_encoder.base_fc1.weight"}


def _batch():
    """The flagship batch's keys (__graft_entry__._fake_batch), with seeded
    targets and masks so that every term has a gradient."""
    rng = np.random.RandomState(0)
    return {
        "imgs": rng.rand(B, S, S, 3).astype(np.float32),
        "Ks": fake_K(B, S),
        "root_xyz": np.tile(np.asarray([[[0.0, 0.0, 0.5]]], np.float32), (B, 1, 1)),
        "joints": (rng.randn(B, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "j2d_gt": (rng.rand(B, 21, 2) * S).astype(np.float32),
        "verts": (rng.randn(B, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "segms_gt": (rng.rand(B, S, S) > 0.6).astype(np.float32),
        "texture_con": rng.uniform(0.5, 1.0, B).astype(np.float32),
        "scales": np.full((B,), 0.0282, np.float32),
    }


def _numpy(d):
    return {k: float(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def runs():
    """STEPS train steps of each package from the same weights: per package
    the first step's loss dict, gradients and BatchNorm stats, and every
    step's total."""
    batch = _batch()
    mp = pytest.MonkeyPatch()
    mp.setattr(JRenderer, "_select_faces_msaa", jax_msaa_select_op_by_op)
    try:
        jcfg = JConfig(**CFG)
        jm = JModel(config=jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        v = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b["imgs"], b["Ks"], b["root_xyz"], train=False))(jb)
        v = randomize_variables(v, seed=0)
        state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=jmake_optimizer(jcfg, 1000),
                                   batch_stats=v["batch_stats"])
        step = jmake_train_step(jm, JLossComputer(jcfg), "FreiHand", jcfg)
        sched = jmake_sched(jcfg, 0)
        state, d = step(state, jb, sched)
        jax_run = {"loss": _numpy(d), "totals": [float(d["total"])],
                   "grads": state_dict_from_flax({"params": jax.tree_util.tree_map(
                       lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)}),
                   "stats": {k: x for k, x in state_dict_from_flax(
                       {"params": {}, "batch_stats": state.batch_stats}).items()
                       if k.endswith(("running_mean", "running_var"))}}
        for _ in range(STEPS - 1):
            state, d = step(state, jb, sched)
            jax_run["totals"].append(float(d["total"]))
    finally:
        mp.undo()

    cfg = Config(**CFG)
    model = HiFiHR(cfg)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    tstate = create_train_state(model, cfg)
    tstep = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    tb = {k: torch.tensor(x) for k, x in batch.items()}
    tsched = make_sched(cfg, 0, device="cpu")
    tstate, td = tstep(tstate, tb, tsched)
    port_run = {"loss": _numpy(td), "totals": [float(td["total"])],
                "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                "stats": {k: x.clone() for k, x in model.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))}}
    for _ in range(STEPS - 1):
        tstate, td = tstep(tstate, tb, tsched)
        port_run["totals"].append(float(td["total"]))
    port_run["step"] = int(tstate.step)
    return jax_run, port_run


def test_train_step_loss_terms(runs):
    jax_run, port_run = runs
    assert set(port_run["loss"]) == set(jax_run["loss"]) == set(FIRED) | {"skipped"}
    assert port_run["loss"]["skipped"] == jax_run["loss"]["skipped"] == 0.0
    for k in FIRED:
        np.testing.assert_allclose(port_run["loss"][k], jax_run["loss"][k], rtol=1e-4, err_msg=k)


def test_train_step_gradients(runs):
    jax_run, port_run = runs
    jg, tg = jax_run["grads"], port_run["grads"]
    assert set(jg) == set(tg)
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        if name in ZERO_GRAD_BIASES:
            scale = np.linalg.norm(jg[ZERO_GRAD_BIASES[name]].numpy())
            assert np.linalg.norm(a) < 1e-6 * scale and np.linalg.norm(b) < 1e-6 * scale, name
        elif not b.any():  # outputs no loss reads: the rot, trans and scale heads
            assert not a.any(), name
        else:
            assert rel_l2(a, b) < 1e-3, (name, rel_l2(a, b))
    assert np.linalg.norm(tg["vert_tex"].numpy()) > 0  # the render's gradient reached the albedo


def test_train_step_batchnorm_stats(runs):
    jax_run, port_run = runs
    assert set(port_run["stats"]) == set(jax_run["stats"]) and len(port_run["stats"]) == 2 * 22
    for k, x in port_run["stats"].items():
        np.testing.assert_allclose(x.numpy(), jax_run["stats"][k].numpy(), atol=1e-5, err_msg=k)


def test_train_trajectory(runs):
    jax_run, port_run = runs
    tj, tp = np.asarray(jax_run["totals"]), np.asarray(port_run["totals"])
    assert port_run["step"] == STEPS and np.all(np.isfinite(tp))
    np.testing.assert_allclose(tp[:2], tj[:2], rtol=1e-4)
    np.testing.assert_allclose(tp[2:], tj[2:], rtol=0.1)
    assert tp[-1] < 0.7 * tp[0] and tj[-1] < 0.7 * tj[0]  # both train
