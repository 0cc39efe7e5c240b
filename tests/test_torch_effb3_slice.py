"""The paper's full-supervision config end to end: configs/FreiHAND/
full_rhd_freihand.json (NIMBLE, EfficientNet-b3, L1, the 12 listed losses
with the perceptual loss) loaded by both packages' Config.from_json, cut to
the slice tests' size by overrides (32 px, no light estimation, fp32), and
run through `make_eval_step` and two `make_train_step` steps from the same
converted weights on the same batch of 8, with a seeded nonzero mask (with
an all-zero mask the perceptual composite equals the image and the term is
exactly 0). The perceptual loss runs on JAX's own random VGG19 features,
carried into the port's loss stack by the converter.

The harness and tolerances are tests/test_torch_nimble_slice.py's: the JAX
steps are jitted, with the MSAA face selection run op by op in a host
callback and JAX's fp32 corner accumulation (test side only); the port's own
K1 choice is held at >= 99.5% of pixels and the port then shades JAX's
choice. Eval outputs within 1e-4; the first train step's 12 terms and total
within 1e-4 relative (measured 2.1e-5 at most, mshape) and every gradient
within 1e-3 relative L2 (measured 5.1e-4 at most); the second step's total
within 1e-4 and its terms within 1e-2 (measured 1.8e-5, mtex). The
perceptual term is positive; its gradient to re_img is held against JAX's
in tests/test_torch_losses.py.
"""

from collections import namedtuple
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hifihr_tpu.render.mesh as jmesh
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
from torch_port_helpers import fake_K, jax_msaa_select_op_by_op, randomize_variables, rel_l2

B, S = 8, 32
PAPER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "configs", "FreiHAND", "full_rhd_freihand.json")
OVERRIDES = dict(image_size=S, light_estimation=False, compute_dtype="float32")
LISTED = ("joint_3d", "vert_3d", "mpose", "mshape", "mtex", "bone_direc_3d", "edge_length", "texture", "mrgb",
          "sil", "ssim_tex", "perceptual")
# biases with zero gradient in exact arithmetic, each held under 1e-6 of its
# layer's weight gradient on both sides (measured 4.4e-7 at most): a Linear
# bias that feeds a train-mode BatchNorm, and the last BatchNorm bias of
# MBConv blocks 1-25, a per-channel constant whose every path (the next
# block's 1x1 expand conv, the residuals, the head's 1x1 conv) ends in a
# train-mode BatchNorm that removes it
ZERO_GRAD_BIASES = {"hand_encoder.base_fc0.bias": "hand_encoder.base_fc0.weight",
                    "hand_encoder.base_fc1.bias": "hand_encoder.base_fc1.weight",
                    **{f"encoder.backbone.block{i}.bn2.bias": f"encoder.backbone.block{i}.bn2.weight"
                       for i in range(1, 26)}}


def _batch():
    """The config's train queries (images, Ks, joints, scales, verts, masks)
    as the FreiHAND loader names them, seeded; the mask covers ~40%."""
    rng = np.random.RandomState(0)
    return {
        "imgs": rng.rand(B, S, S, 3).astype(np.float32),
        "Ks": fake_K(B, S),
        "root_xyz": np.tile(np.asarray([[[0.0, 0.0, 0.5]]], np.float32), (B, 1, 1)),
        "joints": (rng.randn(B, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "verts": (rng.randn(B, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "segms_gt": (rng.rand(B, S, S) > 0.6).astype(np.float32),
        "scales": np.full((B,), 0.0282, np.float32),
    }


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _no_incidence(*_):
    raise RuntimeError("the test takes JAX's fp32 corner accumulation")


@pytest.fixture(scope="module")
def runs():
    batch = _batch()
    jax_faces = []
    mp = pytest.MonkeyPatch()
    mp.setattr(JRenderer, "_select_faces_msaa",
               lambda self, v, K: jax_msaa_select_op_by_op(self, v, K, record=jax_faces))
    mp.setattr(jmesh, "_corner_incidence", _no_incidence)
    try:
        jcfg = JConfig.from_json(PAPER, **OVERRIDES)
        jm = JModel(config=jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        v = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b["imgs"], b["Ks"], b["root_xyz"], train=False))(jb)
        v = randomize_variables(v, seed=0)
        del jax_faces[:]  # init's render
        estate = namedtuple("State", "params batch_stats")(v["params"], v["batch_stats"])
        jeval = {k: np.asarray(x) for k, x in jmake_eval_step(jm, "FreiHand", jcfg)(estate, jb).items()}
        state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=jmake_optimizer(jcfg, 1000),
                                   batch_stats=v["batch_stats"])
        jlc = JLossComputer(jcfg)
        step = jmake_train_step(jm, jlc, "FreiHand", jcfg)
        sched = jmake_sched(jcfg, 0)
        state, d1 = step(state, jb, sched)
        grads = state_dict_from_flax({"params": jax.tree_util.tree_map(
            lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)})
        state, d2 = step(state, jb, sched)
        jax_run = {"eval": jeval, "loss": [_floats(d1), _floats(d2)], "grads": grads,
                   "faces": [f for f, _ in jax_faces]}
    finally:
        mp.undo()
    assert len(jax_faces) == 3  # the eval step and two train steps

    cfg = Config.from_json(PAPER, **OVERRIDES)
    model = HiFiHR(cfg)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    own_faces = []
    select = model.renderer.select_faces

    def jax_choice(verts_cam, K):
        """The port's own K1 choice, kept, and JAX's, returned."""
        own_faces.append(select(verts_cam, K)[0].numpy())
        fid, cov = jax_faces[len(own_faces) - 1]
        return torch.tensor(fid), torch.tensor(cov)

    model.renderer.select_faces = jax_choice
    tb = {k: torch.tensor(x) for k, x in batch.items()}
    teval = {k: x.numpy() for k, x in make_eval_step(model, "FreiHand", cfg)(tb).items()}
    tstate = create_train_state(model, cfg)
    tlc = LossComputer(cfg)
    tlc.vgg.load_state_dict(state_dict_from_flax(jlc.vgg_params), strict=True)
    tstep = make_train_step(model, tlc, "FreiHand", cfg)
    tsched = make_sched(cfg, 0, device="cpu")
    tstate, d1 = tstep(tstate, tb, tsched)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    tstate, d2 = tstep(tstate, tb, tsched)
    port_run = {"eval": teval, "loss": [_floats(d1), _floats(d2)], "grads": grads, "faces": own_faces,
                "step": int(tstate.step), "cfg": cfg, "jcfg": jcfg}
    return jax_run, port_run


def test_paper_config_loads_alike(runs):
    cfg, jcfg = runs[1]["cfg"], runs[1]["jcfg"]
    assert cfg.to_dict() == jcfg.to_dict()
    assert (cfg.pretrain, cfg.hand_model, cfg.base_loss_fn, cfg.losses) == ("effb3", "nimble", "L1", LISTED)


def test_paper_own_face_choice(runs):
    jax_run, port_run = runs
    assert len(port_run["faces"]) == 3
    for what, own, ref in zip(("eval", "train step 1", "train step 2"), port_run["faces"], jax_run["faces"]):
        assert 0.02 < (ref >= 0).mean() < 0.95, what
        assert (own == ref).mean() >= 0.995, (what, (own != ref).sum())


@pytest.mark.parametrize("key", ["joints", "mano_verts", "j2d", "pose_params", "shape_params", "trans", "scale",
                                 "re_img", "re_depth", "re_sil"])
def test_paper_eval_step(runs, key):
    ref, out = runs[0]["eval"], runs[1]["eval"]
    assert set(out) == set(ref)
    assert out[key].shape == ref[key].shape and np.all(np.isfinite(out[key]))
    np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=1e-4)


def test_paper_train_step_loss_terms(runs):
    jax_run, port_run = runs
    for step in range(2):
        jl, pl = jax_run["loss"][step], port_run["loss"][step]
        assert set(pl) == set(jl) == set(LISTED) | {"total", "skipped"}
        assert pl["skipped"] == jl["skipped"] == 0.0
        for k in LISTED + ("total",):
            rtol = 1e-4 if step == 0 or k == "total" else 1e-2
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, err_msg=f"step {step + 1} {k}")
    assert port_run["loss"][0]["perceptual"] > 0
    assert port_run["step"] == 2


def test_paper_train_step_gradients(runs):
    jax_run, port_run = runs
    jg, tg = jax_run["grads"], port_run["grads"]
    assert set(jg) == set(tg)
    assert "encoder.backbone.block25.se_expand.bias" in tg and "hand_encoder.tex_out.weight" in tg
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        if name in ZERO_GRAD_BIASES:
            scale = np.linalg.norm(jg[ZERO_GRAD_BIASES[name]].numpy())
            assert np.linalg.norm(a) < 1e-6 * scale and np.linalg.norm(b) < 1e-6 * scale, name
        elif not b.any():  # outputs no loss reads
            assert not a.any(), name
        else:
            assert rel_l2(a, b) < 1e-3, (name, rel_l2(a, b))
