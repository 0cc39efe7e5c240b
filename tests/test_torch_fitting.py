"""Test-time MANO fitting in the port (hifihr_tpu_torch/training/fitting.py
and the Trainer's eval) against the JAX package's, on the CPU.

`make_fitting_fn` on the same numpy inputs (batch 3, MANO with 45 PCA
components, targets scattered around the image centre at 224 px):
- after 1 and 2 Adam steps every refined parameter within 1e-5 (measured
  2.4e-7);
- after 50, 51, 100 and 101 steps (each side of both halvings of the
  learning rate) and after the full 151 within 1.5e-5. That bound is set by
  JAX against itself: with every input moved by one ulp its own fit moves
  by up to 1.4e-6 after 151 steps (the pose), and the port, whose every sum
  rounds in another order, is held within ten times that (measured 5.3e-6;
  the fit moves the parameters by up to 0.84);
- the learning rate of every update count equal to optax's
  piecewise_constant_schedule(0.01, {50: 0.5, 100: 0.5}), and the update
  with count 50 (the 51st) already at 0.005: a fit whose 51st update took
  0.01 would move the parameters by ~5e-3 more than JAX's.

`Trainer.evaluate` with `test_refinement` (res18, 32 px, MANO, no render,
fp32, the synthetic stand-in: 12 val samples in batches of 8, the last one
ragged) from the JAX Trainer's own init converted: pa_mpjpe_cm at 1e-4
relative, as tests/test_torch_trainer.py holds it, and
pa_mpjpe_refined_cm at 1e-3 relative (the fit from the untrained network's
far-off parameters; the refined joints within 1e-4 m of JAX's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hifihr_tpu.training.loop as jloop
from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.data.base import BatchLoader as JBatchLoader
from hifihr_tpu.data.synthetic import SyntheticHandDataset as JSynthetic
from hifihr_tpu.hand.mano import ManoLayer as JMano
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.parallel.mesh import make_mesh as jmake_mesh
from hifihr_tpu.training.fitting import make_fitting_fn as jmake_fitting_fn
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.data.base import BatchLoader
from hifihr_tpu_torch.data.synthetic import SyntheticHandDataset
from hifihr_tpu_torch.hand.mano import ManoLayer
from hifihr_tpu_torch.models.hifihr import HiFiHR
from hifihr_tpu_torch.training import fitting
from hifihr_tpu_torch.training.loop import Trainer
from torch_port_helpers import fake_K, numpy_tree

FIT_B, FIT_S = 3, 224
ARGS = ("pose", "betas", "trans", "scale", "Ks", "target", "conf", "root")


def _fit_inputs() -> dict:
    rng = np.random.RandomState(0)
    return dict(pose=(rng.randn(FIT_B, 48) * 0.3).astype(np.float32),
                betas=(rng.randn(FIT_B, 10) * 0.5).astype(np.float32),
                trans=(rng.randn(FIT_B, 3) * 0.01).astype(np.float32),
                scale=(1 + rng.randn(FIT_B, 1) * 0.1).astype(np.float32), Ks=fake_K(FIT_B, FIT_S),
                target=(FIT_S / 2 + rng.randn(FIT_B, 21, 2) * 20).astype(np.float32),
                conf=np.ones((FIT_B, 21, 1), np.float32),
                root=np.tile(np.float32([[[0.0, 0.0, 0.5]]]), (FIT_B, 1, 1)))


@pytest.fixture(scope="module")
def fits():
    """{n_steps: (JAX's refined parameters, the port's)}."""
    x = _fit_inputs()
    out = {}
    for n in (1, 2, 50, 51, 100, 101, 151):
        jp = jmake_fitting_fn(JMano(ncomps=45), n_steps=n)(*(jnp.asarray(x[k]) for k in ARGS))
        tp = fitting.make_fitting_fn(ManoLayer(ncomps=45), n_steps=n, device="cpu")(*(torch.tensor(x[k])
                                                                                      for k in ARGS))
        out[n] = ({k: np.asarray(v) for k, v in jp.items()}, {k: v.numpy() for k, v in tp.items()})
    return out


@pytest.mark.parametrize("n", [1, 2, 50, 51, 100, 101, 151])
def test_fit_matches_jax(fits, n):
    jp, tp = fits[n]
    x = _fit_inputs()
    assert set(tp) == set(jp) == set(fitting.PARAMS)
    for k in fitting.PARAMS:
        assert tp[k].shape == x[k].shape and np.all(np.isfinite(tp[k])), k
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-5 if n <= 2 else 1.5e-5, err_msg=k)
    assert max(np.abs(tp[k] - x[k]).max() for k in tp) > 0.9 * 0.01 * min(n, 50) / 50  # it moved


def test_learning_rate_boundaries(fits):
    """Halved when the update count reaches 50 and 100, as optax's schedule:
    the 51st update takes 0.005, the 101st 0.0025."""
    schedule = optax.piecewise_constant_schedule(0.01, {50: 0.5, 100: 0.5})
    for count in range(fitting.N_STEPS):
        assert fitting.learning_rate(count) == float(np.float32(schedule(count))), count
    assert (fitting.learning_rate(49), fitting.learning_rate(50)) == (float(np.float32(0.01)),
                                                                      float(np.float32(0.005)))
    assert (fitting.learning_rate(99), fitting.learning_rate(100)) == (float(np.float32(0.005)),
                                                                       float(np.float32(0.0025)))
    # the 51st and 101st updates of both packages agree, step by step
    for before, after in ((50, 51), (100, 101)):
        jstep = {k: fits[after][0][k] - fits[before][0][k] for k in fitting.PARAMS}
        tstep = {k: fits[after][1][k] - fits[before][1][k] for k in fitting.PARAMS}
        for k in fitting.PARAMS:
            np.testing.assert_allclose(tstep[k], jstep[k], rtol=0, atol=3e-5, err_msg=(after, k))
        lr = fitting.learning_rate(before)
        # Adam's normalised step is of the order of lr per entry, so a step
        # at the rate before the boundary would miss JAX's by ~lr >> 3e-5
        biggest = max(np.abs(tstep[k]).max() for k in fitting.PARAMS)
        assert 0.5 * lr < biggest < 2 * lr, (after, biggest, lr)


S, B, N_TRAIN, N_VAL = 32, 8, 16, 12
CFG = dict(pretrain="res18", hand_model="mano", render=False, light_estimation=False, image_size=S,
           compute_dtype="float32", losses=("joint_3d", "mpose"), train_batch=B, val_batch=B, num_workers=2,
           demo_freq=10000, save_mode="only_latest", test_refinement=True)


def _loaders(ds_cls, loader_cls):
    train = loader_cls(ds_cls(size=N_TRAIN, image_size=S), B, num_workers=2)
    val = loader_cls(ds_cls(size=N_VAL, image_size=S, seed=5), B, shuffle=False, drop_last=False)
    return train, val, {"xyz": val.dataset.joints, "verts": val.dataset.verts}


def _jitted_init_state(model, config, rng, sample_batch, steps_per_epoch=1000):
    """JAX's create_train_state with the flax init jitted (run op by op it
    compiles each of its ~600 operations); the port starts from whatever
    init it makes, converted."""
    from hifihr_tpu.training.train_state import create_train_state

    class JittedInit:
        def __getattr__(self, name):
            return getattr(model, name)

        def init(self, rng, imgs, Ks, root_xyz, train=False):
            return jax.jit(lambda r, i, k, z: model.init(r, i, k, z, train=train))(rng, imgs, Ks, root_xyz)

    return create_train_state(JittedInit(), config, rng, sample_batch, steps_per_epoch)


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    base = tmp_path_factory.mktemp("fitting")
    mp = pytest.MonkeyPatch()
    mp.setattr(jloop, "make_mesh", lambda fsdp=1: jmake_mesh(n_devices=1))
    refined = {}
    real_refine = jloop.Trainer._refine

    def jrefine(self, out, batch):
        joints, verts = real_refine(self, out, batch)
        refined.setdefault("jax", []).append(np.asarray(joints))
        return joints, verts

    mp.setattr(jloop.Trainer, "_refine", jrefine)
    mp.setattr(jloop, "create_train_state", _jitted_init_state)
    try:
        jcfg = JConfig(**CFG, base_out_path=str(base / "jax"))
        jtrain, jval, gt = _loaders(JSynthetic, JBatchLoader)
        jt = jloop.Trainer(jcfg, JModel(config=jcfg), jtrain, jval, eval_gt=gt, out_dir=jcfg.base_out_path)
        init = numpy_tree({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
        jev = jt.evaluate(-1)
    finally:
        mp.undo()

    cfg = Config(**CFG, base_out_path=str(base / "port"))
    model = HiFiHR(cfg)
    model.load_state_dict(state_dict_from_flax(init), strict=True)
    train, val, gt = _loaders(SyntheticHandDataset, BatchLoader)
    trainer = Trainer(cfg, model, train, val, eval_gt=gt, out_dir=cfg.base_out_path)
    port_refine = trainer._refine

    def trefine(out, batch):
        joints, verts = port_refine(out, batch)
        refined.setdefault("port", []).append(joints.numpy())
        return joints, verts

    trainer._refine = trefine
    ev = trainer.evaluate(-1)
    return jev, ev, refined


def test_evaluate_reports_refined_pa_mpjpe(evals):
    jev, ev, refined = evals
    assert "pa_mpjpe_refined_cm" in jev and "pa_mpjpe_refined_cm" in ev
    assert np.isfinite(ev["pa_mpjpe_refined_cm"]) and np.isfinite(ev["pa_mpjpe_cm"])
    np.testing.assert_allclose(ev["pa_mpjpe_cm"], jev["pa_mpjpe_cm"], rtol=1e-4)
    np.testing.assert_allclose(ev["pa_mpjpe_refined_cm"], jev["pa_mpjpe_refined_cm"], rtol=1e-3)
    assert len(refined["port"]) == len(refined["jax"]) == 2  # 12 samples in batches of 8
    for a, b in zip(refined["port"], refined["jax"]):
        assert a.shape == b.shape == (B, 21, 3)
        np.testing.assert_allclose(a[:, 9], 0.0, atol=1e-7)  # root-relative at joint 9
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_refinement_only_for_mano(tmp_path):
    """test_refinement builds for every hand model, and the eval refines
    MANO only, as the JAX package's."""
    for hand in ("nimble", "mano_new"):
        cfg = Config(**dict(CFG, hand_model=hand), base_out_path=str(tmp_path / hand))
        assert cfg.test_refinement
    cfg = Config(**dict(CFG, hand_model="mano_new"), base_out_path=str(tmp_path / "mano_new"))
    train, val, gt = _loaders(SyntheticHandDataset, BatchLoader)
    from hifihr_tpu_torch.models.hifihr import build_model

    trainer = Trainer(cfg, build_model(cfg, device="cpu"), train, val, eval_gt=gt, out_dir=cfg.base_out_path)
    ev = trainer.evaluate(-1)
    assert "pa_mpjpe_cm" in ev and "pa_mpjpe_refined_cm" not in ev
