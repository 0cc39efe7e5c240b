"""Reading the JAX package's orbax checkpoints in the port: JAX's
CheckpointManager saves a seeded train state (two Adam updates taken, so
both moments and the count are nonzero), tools/export_flax_checkpoint.py
writes its npz, and hifihr_tpu_torch/training/checkpoint.py::load_flax_export
loads it into the port's TrainState. The port then gives JAX's eval outputs
(within 1e-5) and, fed the same gradient, the same next Adam update as
optax (parameters within 1e-6 relative to their scale, moments within
1e-6 relative, the count and the epoch equal). With `only_train_regressor`
JAX's optimizer is an optax.multi_transform whose frozen group keeps no
moments; the port's frozen parameters are outside its flat buffer.
The configuration is res18 at 32 px, no render, fp32 (the checkpoint path
is the same for every model).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.training.checkpoint import CheckpointManager as JCheckpointManager
from hifihr_tpu.training.train_state import create_train_state as jcreate_train_state
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.models.hifihr import HiFiHR
from hifihr_tpu_torch.training.checkpoint import load_flax_export
from hifihr_tpu_torch.training.train_state import create_train_state
from torch_port_helpers import seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from export_flax_checkpoint import export  # noqa: E402

S = 32


def _cfg(frozen: bool) -> dict:
    return dict(pretrain="res18", hand_model="mano", render=False, light_estimation=False, image_size=S,
                compute_dtype="float32", only_train_regressor=frozen, init_lr=1e-3)


@jax.jit
def _update(state, grads):
    """One optax update, jitted: eagerly each leaf's ops dispatch one by
    one (several seconds an update)."""
    return state.apply_gradients(grads=grads)


def _grads_like(params, seed: int):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.1), params)


@pytest.fixture(scope="module", params=[False, True], ids=["all_trained", "frozen_encoder"])
def exported(request, tmp_path_factory):
    """JAX's saved and exported train state, and the port's loaded from it.
    JAX's create_train_state builds the state (the optimizer, frozen groups
    included) around seeded variables, which stand in for flax's eager init
    (half a minute for this model)."""
    frozen = request.param
    tmp = tmp_path_factory.mktemp("ckpt")
    jcfg = JConfig(**_cfg(frozen))
    jm = JModel(config=jcfg)
    imgs = np.random.RandomState(0).rand(2, S, S, 3).astype(np.float32)
    v = seeded_variables(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False), imgs), 1)
    v = jax.tree_util.tree_map(jnp.asarray, v)
    mp = pytest.MonkeyPatch()
    mp.setattr(JModel, "init", lambda self, *args, **kwargs: v)
    try:
        state = jcreate_train_state(jm, jcfg, jax.random.PRNGKey(0), {"imgs": imgs})
    finally:
        mp.undo()
    for seed in (2, 3):  # two updates: nonzero moments, count 2
        state = _update(state, _grads_like(state.params, seed))
    JCheckpointManager(str(tmp / "model"), "only_latest").save(state, 7)
    npz = str(tmp / "export.npz")
    flat = export(str(tmp / "model"), npz)

    cfg = Config(**_cfg(frozen))
    model = HiFiHR(cfg)  # its own random weights, all replaced by the load
    tstate = create_train_state(model, cfg)
    tstate, epoch = load_flax_export(npz, tstate)
    return {"frozen": frozen, "jm": jm, "state": state, "flat": flat, "tstate": tstate, "epoch": epoch,
            "imgs": imgs}


def test_export_keys(exported):
    flat, state = exported["flat"], exported["state"]
    assert int(flat["count"]) == 2 and int(flat["epoch"]) == 7
    n_params = len(jax.tree_util.tree_leaves(state.params))
    assert sum(k.startswith("params/") for k in flat) == n_params
    n_mu = sum(k.startswith("mu/") for k in flat)
    if exported["frozen"]:  # no moments for the frozen encoder
        assert 0 < n_mu < n_params and not any(k.startswith("mu/encoder/") for k in flat)
    else:
        assert n_mu == n_params


def test_loaded_state_gives_jax_eval_outputs(exported):
    jm, state, imgs = exported["jm"], exported["state"], exported["imgs"]
    assert exported["epoch"] == 7 and int(exported["tstate"].step) == 2
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(imgs))
    model = exported["tstate"].model.eval()
    with torch.no_grad():
        out = model(torch.tensor(imgs))
    for k in ("pose_params", "shape_params", "scale", "trans", "rot", "joints", "mano_verts"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def test_next_adam_step_matches_optax(exported):
    """One more update from the loaded state on the same gradient: optax's
    and the port's parameters and moments agree."""
    state, tstate = exported["state"], exported["tstate"]
    grads = _grads_like(state.params, 4)
    new = _update(state, grads)
    opt = tstate.optimizer
    gsd = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    names = {id(p): n for n, p in tstate.model.named_parameters()}
    opt.zero_grad()
    for p in opt.params:
        p.grad.copy_(gsd[names[id(p)]])
    opt.step(torch.tensor(True))
    assert int(opt.count) == 3
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, new.params)})
    for name, p in tstate.model.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * max(1.0, float(w.abs().max())), err_msg=name)
    adam = new.opt_state.inner_states["trained"].inner_state[0] if exported["frozen"] else new.opt_state[0]
    mu, nu = opt.full_moments()
    for kind, got in (("mu", mu), ("nu", nu)):
        ref = state_dict_from_flax({"params": _drop_masked(getattr(adam, kind))})
        for p in opt.params:
            view = got.as_strided(p.shape, p.stride(), p.storage_offset())
            r = ref[names[id(p)]]
            np.testing.assert_allclose(view.numpy(), r.numpy(), rtol=0,
                                       atol=1e-6 * max(float(r.abs().max()), 1e-12), err_msg=kind)


def _drop_masked(tree):
    """optax.masked's moments as a nested dict without its MaskedNode leaves."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            sub = _drop_masked(v)
            if sub:
                out[k] = sub
        elif not isinstance(v, optax.MaskedNode):
            out[k] = np.asarray(v)
    return out
