"""The mano_new branch (the YTBHand baseline, hand_model="mano_new") in the
port against the JAX package's: `make_eval_step` and two `make_train_step`
steps of both packages from the same converted weights on the same batch,
in the shipped configuration configs/FreiHAND/fully_superv_freihand_mano_new.json
(ResNet-50, L1, joint_3d and mpose, use_mean_shape, Adam at lr 1e-3) cut to
32 px and batch 8 (flax's train-mode BatchNorm statistics are ill
conditioned at batch 2, tests/test_torch_train_slice.py). No render, so no
TPU kernel runs on this path. Also: the encoder runs in fp32 whatever
`compute_dtype` says, as JAX builds it without a dtype; the four dense
layers start as flax's default init draws them.

Tolerances, those of tests/test_torch_train_slice.py where JAX's own step
allows them:
- eval outputs: joints, mano_verts and j2d 1e-4 absolute (j2d in pixels at
  f = 57.6), the MANO parameters 1e-4;
- the first train step's 2 terms and total within 1e-4 relative;
- the heads' gradients (theta_fc0/1, MMPool's mix) within 1e-3 relative
  L2 (the shape head's are zero: use_mean_shape zeroes beta);
- the encoder's within 1e-3, or 20x JAX's own movement where that is
  larger, and 5e-2 at most. ResNet-50's backward at random init is ill
  conditioned in JAX itself: with its input images moved by one ulp, its
  own gradients move by 3.8e-4 in the heads, 7.7e-4 at layer4_2.conv3 and
  1.5-2.3% from layer4_0 down to the stem (measured; train-mode
  BatchNorm's backward over 8 x 2 x 2 values per channel at layer4
  amplifies rounding). The test measures that movement in its own run (one
  more JAX step on the moved images). The port's rounding differs at every
  operation, JAX's moved input only at the input, so on the last block,
  whose BatchNorm backward is itself ill conditioned, the port moves
  further than JAX does under one ulp: 8.7e-3 against 7.7e-4 at
  layer4_2.bn2 (measured; 2.5e-2 at most, the median ratio 1.1);
- the BatchNorm running stats after the first step within 1e-5, or 10x
  JAX's own movement (flax's E[x^2] - E[x]^2 variance loses digits on some
  channels; measured at most 3.5x); the second step's total within 1e-4
  relative, or 3x JAX's own movement (measured 4.7e-3 for JAX under one
  ulp, 1.0e-3 for the port).
"""

import os
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.losses.stack import LossComputer as JLossComputer
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.training.steps import make_eval_step as jmake_eval_step
from hifihr_tpu.training.steps import make_sched as jmake_sched
from hifihr_tpu.training.steps import make_train_step as jmake_train_step
from hifihr_tpu.training.train_state import TrainState as JTrainState
from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.models.hifihr import HiFiHR, init_weights
from hifihr_tpu_torch.training.steps import make_eval_step, make_sched, make_train_step
from hifihr_tpu_torch.training.train_state import create_train_state
from torch_port_helpers import fake_K, numpy_tree, randomize_variables, rel_l2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "FreiHAND", "fully_superv_freihand_mano_new.json")
B, S = 8, 32
OVER = dict(image_size=S)
FIRED = ("joint_3d", "mpose", "total")
DENSE = {"beta_fc0": (2048, 512), "beta_fc1": (512, 10), "theta_fc0": (2048, 512), "theta_fc1": (512, 48)}


def _batch():
    """The config's train keys (images, Ks, joints, scales) and root_xyz."""
    rng = np.random.RandomState(0)
    return {
        "imgs": rng.rand(B, S, S, 3).astype(np.float32),
        "Ks": fake_K(B, S),
        "root_xyz": np.tile(np.asarray([[[0.0, 0.0, 0.5]]], np.float32), (B, 1, 1)),
        "joints": (rng.randn(B, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "scales": np.full((B,), 0.0282, np.float32),
    }


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _stats(sd):
    return {k: np.asarray(x) for k, x in sd.items() if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def runs():
    batch = _batch()
    jcfg = JConfig.from_json(CONFIG, **OVER)
    assert (jcfg.hand_model, jcfg.render, jcfg.base_loss_fn, jcfg.use_mean_shape) == ("mano_new", False, "L1", True)
    jm = JModel(config=jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = randomize_variables(jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(jb["imgs"]), seed=0)
    estate = namedtuple("State", "params batch_stats")(v["params"], v["batch_stats"])
    jeval = {k: np.asarray(x) for k, x in jmake_eval_step(jm, "FreiHand", jcfg)(estate, jb).items()}
    step = jmake_train_step(jm, JLossComputer(jcfg), "FreiHand", jcfg)
    sched = jmake_sched(jcfg, 0)

    def two_steps(b):
        state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=jmake_optimizer(jcfg, 1000),
                                   batch_stats=v["batch_stats"])
        state, d1 = step(state, b, sched)
        run = {"loss": _floats(d1),
               "grads": state_dict_from_flax({"params": jax.tree_util.tree_map(
                   lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)}),
               "stats": _stats(state_dict_from_flax({"params": {}, "batch_stats": numpy_tree(state.batch_stats)}))}
        state, d2 = step(state, b, sched)
        run["loss2"] = _floats(d2)
        return run

    jax_run = dict(two_steps(jb), eval=jeval)
    # JAX against itself, its images moved by one ulp: the movement the tolerances scale with
    jax_run["ulp"] = two_steps(dict(jb, imgs=jnp.asarray(np.nextafter(batch["imgs"], np.float32(2)))))

    cfg = Config.from_json(CONFIG, **OVER)
    model = HiFiHR(cfg)
    jax_run["init"] = state_dict_from_flax(v)  # flax's init; randomize_variables moves no Dense kernel
    model.load_state_dict(jax_run["init"], strict=True)
    tb = {k: torch.tensor(x) for k, x in batch.items()}
    teval = {k: x.numpy() for k, x in make_eval_step(model, "FreiHand", cfg)(tb).items()}
    tstate = create_train_state(model, cfg)
    tstep = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    tsched = make_sched(cfg, 0, device="cpu")
    tstate, d1 = tstep(tstate, tb, tsched)
    port_run = {"eval": teval, "loss": _floats(d1), "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                "stats": _stats({k: x.clone() for k, x in model.state_dict().items()})}
    tstate, d2 = tstep(tstate, tb, tsched)
    port_run["loss2"], port_run["step"] = _floats(d2), int(tstate.step)
    return jax_run, port_run


def test_mano_new_eval_step_keys_and_shapes(runs):
    ref, out = runs[0]["eval"], runs[1]["eval"]
    assert set(out) == set(ref) == {"joints", "mano_verts", "j2d", "pose_params", "shape_params"}
    shapes = {"joints": (B, 21, 3), "mano_verts": (B, 778, 3), "j2d": (B, 21, 2), "pose_params": (B, 48),
              "shape_params": (B, 10)}
    for k, shp in shapes.items():
        assert out[k].shape == ref[k].shape == shp, k
        assert np.all(np.isfinite(out[k])), k
    np.testing.assert_allclose(out["joints"][:, 9], 0.0, atol=1e-6)  # root-centred
    assert not out["shape_params"].any()  # use_mean_shape


@pytest.mark.parametrize("key", ["joints", "mano_verts", "j2d", "pose_params", "shape_params"])
def test_mano_new_eval_step_matches_jax(runs, key):
    ref, out = runs[0]["eval"], runs[1]["eval"]
    np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=1e-4)


def test_mano_new_train_step_loss_terms(runs):
    jax_run, port_run = runs
    assert set(port_run["loss"]) == set(jax_run["loss"]) == set(FIRED) | {"skipped"}
    assert port_run["loss"]["skipped"] == jax_run["loss"]["skipped"] == 0.0
    for k in FIRED:
        np.testing.assert_allclose(port_run["loss"][k], jax_run["loss"][k], rtol=1e-4, err_msg=k)
    want = jax_run["loss2"]["total"]
    own = abs(jax_run["ulp"]["loss2"]["total"] - want) / want
    np.testing.assert_allclose(port_run["loss2"]["total"], want, rtol=max(1e-4, 3 * own))
    assert port_run["step"] == 2


def test_mano_new_train_step_gradients(runs):
    jax_run, port_run = runs
    jg, tg = jax_run["grads"], port_run["grads"]
    assert set(jg) == set(tg) and {f"{n}.weight" for n in DENSE} <= set(tg)
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        if not b.any():  # the shape head: use_mean_shape zeroes beta
            assert name.startswith("beta_fc") and not a.any(), name
        else:
            tol = min(5e-2, max(1e-3, 20 * rel_l2(jax_run["ulp"]["grads"][name].numpy(), b)))
            assert rel_l2(a, b) < tol, (name, rel_l2(a, b), tol)
    # the heads' gradients are well conditioned: held at 1e-3 without the scaling
    for name in ("theta_fc0.weight", "theta_fc1.weight", "theta_fc1.bias", "encoder.mmpool.p"):
        assert rel_l2(tg[name].numpy(), jg[name].numpy()) < 1e-3, name
    assert np.linalg.norm(tg["theta_fc1.weight"].numpy()) > 0


def test_mano_new_train_step_batchnorm_stats(runs):
    jax_run, port_run = runs
    assert set(port_run["stats"]) == set(jax_run["stats"]) and len(port_run["stats"]) == 2 * 53
    for k, x in port_run["stats"].items():
        own = np.abs(jax_run["ulp"]["stats"][k] - jax_run["stats"][k]).max()
        np.testing.assert_allclose(x, jax_run["stats"][k], atol=max(1e-5, 10 * own), err_msg=k)


def test_mano_new_encoder_runs_in_fp32():
    """The shipped config leaves compute_dtype at bfloat16; JAX's mano_new
    encoder is fp32 all the same, and so is the port's under autocast.
    The same hooks see bf16 convs on the MANO branch."""
    seen = {}
    for hand in ("mano_new", "mano"):
        cfg = Config.from_json(CONFIG, hand_model=hand, image_size=S, render=False, light_estimation=False)
        assert cfg.compute_dtype == "bfloat16"
        model = init_weights(HiFiHR(cfg), seed=0).eval()
        dtypes = []
        hooks = [m.register_forward_hook(lambda m, i, o: dtypes.append(o.dtype))
                 for m in model.encoder.modules() if isinstance(m, torch.nn.Conv2d)]
        with torch.no_grad():
            out = model(torch.rand(2, S, S, 3), torch.tensor(fake_K(2, S)), torch.full((2, 1, 3), 0.5))
        for h in hooks:
            h.remove()
        seen[hand] = set(dtypes)
        assert out["joints"].dtype == torch.float32
    assert seen["mano_new"] == {torch.float32}
    assert seen["mano"] == {torch.bfloat16}


def test_mano_new_dense_init(runs):
    """init_weights draws the four dense layers as flax's default init:
    lecun_normal (variance 1 / fan_in, truncated at 2 sigma), zero biases;
    each weight's std held against the wanted one and against the flax
    model.init of the fixture within 5% or 5 sigma of the std's estimate,
    5 / sqrt(2n), whichever is tighter (tests/test_torch_modules.py's
    rule)."""
    model = init_weights(HiFiHR(Config.from_json(CONFIG)), seed=3)
    jsd = runs[0]["init"]
    linears = {n: m for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    assert set(linears) == set(DENSE)
    for name, (fan_in, fan_out) in DENSE.items():
        w = linears[name].weight.detach()
        assert tuple(w.shape) == (fan_out, fan_in)
        want = (1.0 / fan_in) ** 0.5
        tol = min(0.05, 5 / (2 * w.numel()) ** 0.5)
        for x in (w, jsd[f"{name}.weight"]):
            assert abs(x.std().item() / want - 1) < tol, (name, x.std().item(), want)
            assert x.abs().max().item() <= 2 * want / 0.87962566103423978 * (1 + 1e-6), name
        assert not linears[name].bias.any() and not jsd[f"{name}.bias"].any()
