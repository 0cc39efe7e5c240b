"""The hr18sv2 model end to end: `make_eval_step` and two `make_train_step`
steps of both packages from the same converted weights on the same batch,
in the slice tests' configuration (32 px, 3x3 MSAA, fp32, Adam at lr 1e-3,
batch 8) with `light_estimation=True`, which HRNet's missing low-level tap
turns into the default light in both packages, and the flagship's terms
that read no render (the photometric ones hold nothing HRNet-specific).

The JAX steps are jitted, with the MSAA face choice run op by op
(torch_port_helpers.jax_msaa_select_op_by_op); the port shades JAX's
recorded choice in the eval step and its own is held at >= 99.5% of
pixels, as in tests/test_torch_effb3_slice.py. No loss reads the train
steps' render, so XLA drops it from JAX's step. The weights are drawn in
numpy over the shapes of JAX's init (`seeded_variables`): the jitted flax
init of HRNet compiles for ~20 s, and the steps' compiles take most of
this file's time.

Tolerances. HRNet's backward at random init is ill conditioned in JAX
itself, as ResNet-50's is (tests/test_torch_mano_new.py): its train-mode
BatchNorms over few values per channel (the 72- and 144-channel branches
run at 2x2 and 1x1 at 32 px) amplify rounding, so where JAX's own run moves
more than the slice tests' bounds, the bound scales with that movement,
measured in this run (two more JAX steps on the images moved by one ulp):
- the eval step's outputs: 1e-4 (as the effb3 slice test);
- the first step's terms and total: 1e-4 relative (measured 6.0e-5 at
  most, mscale);
- the second step's total within 1e-4 or 3x JAX's own movement, its terms
  within 1e-2 or 3x JAX's largest own term movement (measured: total
  1.2e-2 against JAX's 5.0e-3; terms 2.8e-2, bone_direc, against JAX's
  1.3e-2, mshape);
- every gradient within 1e-3 relative L2, or 30x JAX's own movement where
  that is larger, and 5e-2 at most (measured: JAX's own movement up to
  1.9e-3; the port's error above 1e-3 on 424 of 503 tensors, 2.4e-2 at
  most, stage1_mod0.branch2_block0.bn2.bias, 22.6x JAX's there, the
  median ratio 1.06); the Linear biases before a train-mode BatchNorm
  (zero in exact arithmetic) under 1e-6 of their weight gradient.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.losses.stack import LossComputer as JLossComputer
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.render.renderer import PhongRenderer as JRenderer
from hifihr_tpu.training.steps import make_eval_step as jmake_eval_step
from hifihr_tpu.training.steps import make_sched as jmake_sched
from hifihr_tpu.training.steps import make_train_step as jmake_train_step
from hifihr_tpu.training.train_state import TrainState as JTrainState
from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.models.hifihr import HiFiHR
from hifihr_tpu_torch.training.steps import make_eval_step, make_sched, make_train_step
from hifihr_tpu_torch.training.train_state import create_train_state
from torch_port_helpers import fake_K, jax_msaa_select_op_by_op, rel_l2, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

B, S = 8, 32
# the flagship's terms that read no render: the photometric ones hold no
# encoder-specific code (the slice tests hold them), and JAX's step then
# drops its render (XLA removes what no output reads), which halves the cost
# of this file
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "bone_direc")
CFG = dict(pretrain="hr18sv2", hand_model="mano", render=True, light_estimation=True, image_size=S,
           aa_factor=3, aa_mode="msaa", compute_dtype="float32", losses=LOSSES, init_lr=1e-3)
FIRED = LOSSES + ("total",)
ZERO_GRAD_BIASES = {"hand_encoder.base_fc0.bias": "hand_encoder.base_fc0.weight",
                    "hand_encoder.base_fc1.bias": "hand_encoder.base_fc1.weight"}


def slice_batch(n: int = B, size: int = S) -> dict:
    """tests/test_torch_train_slice.py's batch without its photometric
    targets (`segms_gt`, `texture_con`), whose terms fire on presence."""
    rng = np.random.RandomState(0)
    return {
        "imgs": rng.rand(n, size, size, 3).astype(np.float32),
        "Ks": fake_K(n, size),
        "root_xyz": np.tile(np.asarray([[[0.0, 0.0, 0.5]]], np.float32), (n, 1, 1)),
        "joints": (rng.randn(n, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "j2d_gt": (rng.rand(n, 21, 2) * size).astype(np.float32),
        "verts": (rng.randn(n, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "scales": np.full((n,), 0.0282, np.float32),
    }


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def step_runs(cfg: dict, batch: dict, seed: int = 0) -> tuple:
    """The eval step and two train steps of each package from the same
    weights: (JAX's run, the port's run)."""
    jax_faces = []
    mp = pytest.MonkeyPatch()
    mp.setattr(JRenderer, "_select_faces_msaa",
               lambda self, v, K: jax_msaa_select_op_by_op(self, v, K, record=jax_faces))
    try:
        jcfg = JConfig(**cfg)
        jm = JModel(config=jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False), jb["imgs"])
        v = seeded_variables(shapes, seed)
        estate = namedtuple("State", "params batch_stats")(v["params"], v["batch_stats"])
        jeval = {k: np.asarray(x) for k, x in jmake_eval_step(jm, "FreiHand", jcfg)(estate, jb).items()}
        tx = jmake_optimizer(jcfg, 1000)  # one object: a new one would retrace the step
        state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=tx, batch_stats=v["batch_stats"])
        step = jmake_train_step(jm, JLossComputer(jcfg), "FreiHand", jcfg)
        sched = jmake_sched(jcfg, 0)
        state, d1 = step(state, jb, sched)
        grads = state_dict_from_flax({"params": jax.tree_util.tree_map(
            lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)})
        state, d2 = step(state, jb, sched)
        jax_run = {"eval": jeval, "loss": [_floats(d1), _floats(d2)], "grads": grads, "variables": v,
                   "faces": [f for f, _ in jax_faces]}
        # JAX against itself, its images moved by one ulp: the movement the
        # tolerances scale with (tests/test_torch_mano_new.py)
        ulp = dict(jb, imgs=jnp.asarray(np.nextafter(batch["imgs"], np.float32(2))))
        state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=tx, batch_stats=v["batch_stats"])
        state, u1 = step(state, ulp, sched)
        ugrads = state_dict_from_flax({"params": jax.tree_util.tree_map(
            lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)})
        state, u2 = step(state, ulp, sched)
        jax_run["ulp"] = {"loss": [_floats(u1), _floats(u2)], "grads": ugrads}
    finally:
        mp.undo()
    assert len(jax_faces) == 1  # the eval step's: no loss reads the train steps' render

    tcfg = Config(**cfg)
    model = HiFiHR(tcfg)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    own_faces = []
    select = model.renderer.select_faces

    def jax_choice(verts_cam, K):
        fid, cov = select(verts_cam, K)
        own_faces.append(fid.numpy())
        if len(own_faces) > len(jax_faces):  # a train step's render, which no loss reads
            return fid, cov
        fid, cov = jax_faces[len(own_faces) - 1]
        return torch.tensor(fid), torch.tensor(cov)

    model.renderer.select_faces = jax_choice
    tb = {k: torch.tensor(x) for k, x in batch.items()}
    teval = {k: x.numpy() for k, x in make_eval_step(model, "FreiHand", tcfg)(tb).items()}
    tstate = create_train_state(model, tcfg)
    tstep = make_train_step(model, LossComputer(tcfg), "FreiHand", tcfg)
    tsched = make_sched(tcfg, 0, device="cpu")
    tstate, d1 = tstep(tstate, tb, tsched)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    tstate, d2 = tstep(tstate, tb, tsched)
    port_run = {"eval": teval, "loss": [_floats(d1), _floats(d2)], "grads": grads, "faces": own_faces,
                "step": int(tstate.step), "model": model}
    return jax_run, port_run


@pytest.fixture(scope="module")
def runs():
    return step_runs(CFG, slice_batch())


def test_hr18sv2_converts_one_to_one(runs):
    """The model's state dict and JAX's variables map one to one, with no
    light estimator on either side although light_estimation is set."""
    v = runs[0]["variables"]
    assert "light_estimator" not in v["params"]
    model = runs[1]["model"]
    assert set(state_dict_from_flax(v)) == set(model.state_dict())
    assert not hasattr(model, "light_estimator")
    assert sum(p.numel() for p in model.parameters()) == sum(x.size for x in jax.tree_util.tree_leaves(v["params"]))
    assert model.state_dict()["encoder.backbone.conv1.weight"].shape == (64, 3, 4, 4)
    assert model.encoder.backbone.out_channels == 1024


def test_hr18sv2_own_face_choice(runs):
    jax_run, port_run = runs
    assert len(port_run["faces"]) == 3  # the port renders in its train steps too
    own, ref = port_run["faces"][0], jax_run["faces"][0]
    assert 0.02 < (ref >= 0).mean() < 0.95
    assert (own == ref).mean() >= 0.995, (own != ref).sum()


@pytest.mark.parametrize("key", ["joints", "mano_verts", "j2d", "pose_params", "shape_params", "trans", "scale",
                                 "re_img", "re_depth", "re_sil"])
def test_hr18sv2_eval_step(runs, key):
    ref, out = runs[0]["eval"], runs[1]["eval"]
    assert set(out) == set(ref) and "light_params" not in out
    assert out[key].shape == ref[key].shape and np.all(np.isfinite(out[key]))
    np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=1e-4)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def test_hr18sv2_train_step_loss_terms(runs):
    jax_run, port_run = runs
    ulp = jax_run["ulp"]["loss"][1]
    own_terms = max(_rel(ulp[k], jax_run["loss"][1][k]) for k in FIRED if k != "total")
    for step in range(2):
        jl, pl = jax_run["loss"][step], port_run["loss"][step]
        assert set(pl) == set(jl) == set(FIRED) | {"skipped"}
        assert pl["skipped"] == jl["skipped"] == 0.0
        for k in FIRED:
            if step == 0:
                rtol = 1e-4
            elif k == "total":
                rtol = max(1e-4, 3 * _rel(ulp[k], jl[k]))
            else:
                rtol = max(1e-2, 3 * own_terms)
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, err_msg=f"step {step + 1} {k}")
    assert port_run["step"] == 2


def test_hr18sv2_train_step_gradients(runs):
    jax_run, port_run = runs
    jg, tg = jax_run["grads"], port_run["grads"]
    assert set(jg) == set(tg)
    assert "encoder.backbone.stage2_mod1.fuse.down_3_0_2_conv.weight" in tg
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        if name in ZERO_GRAD_BIASES:
            scale = np.linalg.norm(jg[ZERO_GRAD_BIASES[name]].numpy())
            assert np.linalg.norm(a) < 1e-6 * scale and np.linalg.norm(b) < 1e-6 * scale, name
        elif not b.any():  # outputs no loss reads
            assert not a.any(), name
        else:
            tol = min(5e-2, max(1e-3, 30 * rel_l2(jax_run["ulp"]["grads"][name].numpy(), b)))
            assert rel_l2(a, b) < tol, (name, rel_l2(a, b), tol)
