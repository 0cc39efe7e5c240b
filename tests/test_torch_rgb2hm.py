"""The rgb2hm heatmap branch of the port (hifihr_tpu_torch/networks/
hourglass.py, the model's branch, its five losses, freeze_hm_estimator and
the pretrain_rgb2hm warm start) against the JAX package's on the CPU.

Tolerances and why:
- NetHMHG alone at 224^2, batch 2, from JAX's seeded init converted (random
  BatchNorm statistics): eval-mode heatmaps within 1e-4 relative (measured
  1.1e-6). In train mode the statistics come from a batch of 2 whose
  deepest maps are 3x3 (224^2: 56 -> 28 -> 14 -> 7 -> 3), 18 values a
  channel, and both sides round away digits there: against the same
  network in float64, JAX's heatmaps are off by 1.0e-4 relative L2 and the
  port's by 3.6e-4, the port's loss coming from PyTorch's CPU
  native_batch_norm over channels-last maps, which sums in fp32 (a
  two-pass var_mean gives 5.8e-5; the card's kernel is another). So in
  train mode each side is held within 1e-3 of float64 and the two within
  1e-3 of each other, and the running statistics (momentum 0.99) within
  2e-4 absolute (measured 7.2e-5);
- heatmaps_to_uv: 1e-6 of the heatmap size, absolute;
- the five losses (kp_cons, hm_integral, hm_integral_gt, open_2dj_de,
  joint_3d_norm) on the same outputs: value and gradients within 1e-6
  relative;
- the eval step and two train steps with rgb2hm (res18, 32 px, batch 8,
  the flagship's geometric losses plus the five, the render off:
  `step_runs`): eval outputs 1e-4 (hm_j2d measured 5.1e-5 px), step-1
  terms 1e-4 (measured 1.2e-5), step-2 total 1e-4 (1.4e-5) and terms 1e-2
  (kp_cons 5.4e-3, where JAX against itself under one ulp of input moves
  7.0e-3), every gradient outside the hourglass 1e-3 (measured 3.3e-5).
  The hourglass's train step is ill conditioned in JAX itself: the branch
  reads the raw images (mean 0.5, no normalisation), and its BatchNorms
  see 8 values a channel at the 1x1 innermost level. Moving JAX's input
  images by one ulp moves JAX's own hourglass gradients by up to 6.5e-2
  relative L2 (stem_conv 4.2e-2, stem_bn 5.1e-2; its output conv hm1
  6.7e-5), and the port differs from JAX there by 3.0e-2 at most (both
  measured with `step_runs` on the batch and on the batch moved by one
  ulp). So the hourglass's gradients are held within 5e-2. Every
  hourglass conv bias has zero gradient in exact arithmetic
  (`_zero_in_exact_arithmetic`), held as the heads' biases are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.losses.stack import LossComputer as JLossComputer
from hifihr_tpu.networks.hourglass import NetHMHG as JNetHMHG
from hifihr_tpu.networks.hourglass import heatmaps_to_uv as jheatmaps_to_uv
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.networks.hourglass import NetHMHG, hourglass_depth, heatmaps_to_uv
from torch_port_helpers import nimble_slice_batch, numpy_tree, randomize_variables, rel_l2

B, S = 8, 32
# the flagship's geometric losses (bench.py:46-49 without sil and iou, which
# read the render) and the five heatmap-branch ones
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "bone_direc")
HM_LOSSES = ("kp_cons", "hm_integral", "hm_integral_gt", "open_2dj_de", "joint_3d_norm")
CFG = dict(pretrain="res18", hand_model="mano", render=False, light_estimation=False, image_size=S,
           compute_dtype="float32", losses=LOSSES + HM_LOSSES, init_lr=1e-3, rgb2hm=True)
FIRED = LOSSES + HM_LOSSES + ("total",)
# the hourglass's gradients at 32 px, batch 8: JAX's own move under one ulp
# of input is up to 6.5e-2 there (the module docstring)
HOURGLASS_GRAD_TOL = 5e-2
ZERO_GRAD_BIASES = {"hand_encoder.base_fc0.bias": "hand_encoder.base_fc0.weight",
                    "hand_encoder.base_fc1.bias": "hand_encoder.base_fc1.weight"}


def _random_stats(variables: dict, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    v = numpy_tree(variables)

    def walk(tree):
        for k, x in tree.items():
            if hasattr(x, "items"):
                walk(x)
            elif k == "mean":
                tree[k] = (rng.randn(*x.shape) * 0.1).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    walk(v["batch_stats"])
    return v


def _port_hourglass(v: dict, size: int) -> NetHMHG:
    sd = state_dict_from_flax({"params": {"rgb2hm": v["params"]}, "batch_stats": {"rgb2hm": v["batch_stats"]}})
    model = NetHMHG(size)
    model.load_state_dict({k[len("rgb2hm."):]: t for k, t in sd.items()}, strict=True)
    return model


@pytest.fixture(scope="module")
def hourglass_224():
    """JAX's NetHMHG at 224^2, batch 2: its variables (random BatchNorm
    statistics), eval- and train-mode heatmaps and updated statistics."""
    x = np.random.RandomState(0).rand(2, 224, 224, 3).astype(np.float32)
    jm = JNetHMHG()
    v = _random_stats(jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(jnp.asarray(x)), 1)
    train, upd = jax.jit(lambda vv, a: jm.apply(vv, a, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    ev = jax.jit(lambda vv, a: jm.apply(vv, a, train=False))(v, jnp.asarray(x))
    return x, v, [np.asarray(h) for h in ev], [np.asarray(h) for h in train], numpy_tree(upd["batch_stats"])


def test_hourglass_224_eval(hourglass_224):
    x, v, jev, _, _ = hourglass_224
    model = _port_hourglass(v, 224).eval()
    assert model.hg0.depth == hourglass_depth(56) == 4 and hasattr(model.hg0, "low1_4")
    with torch.no_grad():
        out = model(torch.tensor(x))
    assert len(out) == len(jev) == 2
    for got, ref in zip(out, jev):
        assert got.shape == ref.shape == (2, 56, 56, 21)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_hourglass_224_train(hourglass_224):
    x, v, _, jtrain, jstats = hourglass_224
    model = _port_hourglass(v, 224).train()
    before = {k: t.clone() for k, t in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    out = model(torch.tensor(x))
    m64 = _port_hourglass(v, 224).double().train()
    ref64 = m64(torch.tensor(x).double())
    for got, ref, truth in zip(out, jtrain, ref64):
        got, truth = got.detach().numpy(), truth.detach().numpy()
        assert rel_l2(got, truth) < 1e-3 and rel_l2(ref, truth) < 1e-3
        assert rel_l2(got, ref) < 1e-3
    stats = state_dict_from_flax({"params": {}, "batch_stats": {"rgb2hm": jstats}})
    after = model.state_dict()
    assert len(before) == 2 * 96
    far = 0
    for k, t in before.items():
        ref = stats[f"rgb2hm.{k}"].numpy()
        np.testing.assert_allclose(after[k].numpy(), ref, atol=2e-4, err_msg=k)
        # with torch's default decay of 0.9 the same batch statistic would
        # land elsewhere: flax's 0.99 is what matches
        batch_stat = (after[k] - 0.99 * t) / 0.01
        far += np.abs((0.9 * t + 0.1 * batch_stat).numpy() - ref).max() > 1e-2
    assert far > len(before) // 2
    norms = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert len(norms) == 96 and all(m.decay == 0.99 and m.eps == 1e-5 for m in norms)


def test_hourglass_nearest_resize_at_odd_sizes():
    """At 224^2 the innermost level is 3 px, resized to 7: half-pixel
    nearest sampling (jax.image.resize 'nearest', F.interpolate's
    'nearest-exact') reads rows 0, 0, 1, 1, 1, 2, 2 where legacy 'nearest'
    reads 0, 0, 0, 1, 1, 2, 2."""
    low = jnp.arange(9, dtype=jnp.float32).reshape(1, 3, 3, 1)
    ref = np.asarray(jax.image.resize(low, (1, 7, 7, 1), "nearest"))[0, :, 0, 0]
    got = torch.nn.functional.interpolate(torch.arange(9.0).reshape(1, 1, 3, 3), size=(7, 7),
                                          mode="nearest-exact")[0, 0, :, 0].numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [0, 0, 3, 3, 3, 6, 6])
    legacy = torch.nn.functional.interpolate(torch.arange(9.0).reshape(1, 1, 3, 3), size=(7, 7),
                                             mode="nearest")[0, 0, :, 0].numpy()
    assert not np.array_equal(legacy, ref)


def test_heatmaps_to_uv():
    hm = (np.random.RandomState(2).randn(3, 14, 10, 21) * 4).astype(np.float32)
    got = heatmaps_to_uv(torch.tensor(hm)).numpy()
    ref = np.asarray(jheatmaps_to_uv(jnp.asarray(hm)))
    assert got.shape == ref.shape == (3, 21, 2)
    np.testing.assert_allclose(got, ref, atol=1e-6 * 14, rtol=0)


def _hm_inputs(seed: int = 4):
    rng = np.random.RandomState(seed)
    j2d = (rng.rand(B, 21, 2) * S).astype(np.float32)
    outputs = {
        "joints": (rng.randn(B, 21, 3) * 0.03).astype(np.float32),
        "j2d": j2d,
        # heatmap joints within 5 px of the projected ones for some joints,
        # so both sides of kp_cons's Huber-like distance are held
        "hm_j2d_list": [(j2d + rng.randn(B, 21, 2) * s).astype(np.float32) for s in (8.0, 3.0)],
    }
    outputs["hm_j2d"] = outputs["hm_j2d_list"][-1]
    examples = {
        "joints": (rng.randn(B, 21, 3) * 0.03).astype(np.float32),
        "j2d_gt": (rng.rand(B, 21, 2) * S).astype(np.float32),
        "open_2dj": (j2d + rng.randn(B, 21, 2) * 6).astype(np.float32),
        "open_2dj_con": rng.rand(B, 21, 1).astype(np.float32),
    }
    return outputs, examples


@pytest.mark.parametrize("name", HM_LOSSES)
def test_five_losses_match_jax(name):
    """Each of the five branches alone against JAX's LossComputer: its value
    and the gradient of the total with respect to every output it reads."""
    outputs, examples = _hm_inputs()
    cfg = dict(losses=(name,), lambda_kp_cons=0.3, lambda_hm=0.05, lambda_j2d_de=0.01, lambda_j3d_norm=10.0)
    diff = ("joints", "j2d", "hm_j2d_list")

    def jtotal(d_out):
        j_out = {**{k: jnp.asarray(v) if k != "hm_j2d_list" else tuple(map(jnp.asarray, v))
                    for k, v in outputs.items()}, **d_out}
        j_out["hm_j2d"] = j_out["hm_j2d_list"][-1]
        d = JLossComputer(JConfig(**cfg))({k: jnp.asarray(v) for k, v in examples.items()}, j_out, "FreiHand")
        return d["total"], d

    (_, jd), jg = jax.value_and_grad(jtotal, has_aux=True)(
        {k: tuple(map(jnp.asarray, outputs[k])) if k == "hm_j2d_list" else jnp.asarray(outputs[k]) for k in diff})
    tout = {k: torch.tensor(outputs[k], requires_grad=True) for k in ("joints", "j2d")}
    tout["hm_j2d_list"] = tuple(torch.tensor(h, requires_grad=True) for h in outputs["hm_j2d_list"])
    tout["hm_j2d"] = tout["hm_j2d_list"][-1]
    td = LossComputer(Config(**cfg))({k: torch.tensor(v) for k, v in examples.items()}, tout, "FreiHand")
    assert set(td) == set(jd) == {name, "total"}
    assert td[name].item() > 0
    np.testing.assert_allclose(td[name].item(), float(jd[name]), rtol=1e-6)
    td["total"].backward()
    pairs = [(tout["joints"].grad, jg["joints"]), (tout["j2d"].grad, jg["j2d"])]
    pairs += [(t.grad, j) for t, j in zip(tout["hm_j2d_list"], jg["hm_j2d_list"])]
    assert any(g is not None and g.abs().max() > 0 for g, _ in pairs)
    for got, ref in pairs:
        ref = np.asarray(ref)
        got = got.numpy() if got is not None else np.zeros_like(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * max(np.abs(ref).max(), 1e-30))


def _slice_batch() -> dict:
    batch = nimble_slice_batch(B, S)
    rng = np.random.RandomState(3)
    batch["open_2dj"] = (rng.rand(B, 21, 2) * S).astype(np.float32)
    batch["open_2dj_con"] = rng.uniform(0.0, 1.0, (B, 21, 1)).astype(np.float32)
    return batch


def step_runs(batch: dict) -> tuple:
    """The eval step and two train steps of each package with rgb2hm from
    the same converted weights (JAX's seeded init with random BatchNorm
    statistics) on `batch`: the eval outputs, both steps' loss dicts and
    the first step's gradients (JAX's from Adam's first moment, mu = (1 -
    b1) g). The render is off: the branch reads the images, not the render,
    and the render's parity is the slice tests' (its MSAA face choice op by
    op would take most of this file's time)."""
    from collections import namedtuple

    from hifihr_tpu.models.hifihr import HiFiHR as JModel
    from hifihr_tpu.training.steps import make_eval_step as jmake_eval_step
    from hifihr_tpu.training.steps import make_sched as jmake_sched
    from hifihr_tpu.training.steps import make_train_step as jmake_train_step
    from hifihr_tpu.training.train_state import TrainState as JTrainState
    from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
    from hifihr_tpu_torch.models.hifihr import HiFiHR
    from hifihr_tpu_torch.training.steps import make_eval_step, make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    def floats(d):
        return {k: float(v) for k, v in d.items()}

    jcfg, tcfg = JConfig(**CFG), Config(**CFG)
    jm = JModel(config=jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b["imgs"], b["Ks"], b["root_xyz"], train=False))(jb)
    v = randomize_variables(v, seed=0)
    estate = namedtuple("State", "params batch_stats")(v["params"], v["batch_stats"])
    jeval = {k: np.asarray(x) for k, x in jmake_eval_step(jm, "FreiHand", jcfg)(estate, jb).items()}
    state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=jmake_optimizer(jcfg, 1000),
                               batch_stats=v["batch_stats"])
    step, sched = jmake_train_step(jm, JLossComputer(jcfg), "FreiHand", jcfg), jmake_sched(jcfg, 0)
    state, d1 = step(state, jb, sched)
    grads = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)})
    state, d2 = step(state, jb, sched)
    jax_run = {"eval": jeval, "loss": [floats(d1), floats(d2)], "grads": grads}

    model = HiFiHR(tcfg)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    tb = {k: torch.tensor(x) for k, x in batch.items()}
    teval = {k: x.numpy() for k, x in make_eval_step(model, "FreiHand", tcfg)(tb).items()}
    tstate = create_train_state(model, tcfg)
    tstep, tsched = make_train_step(model, LossComputer(tcfg), "FreiHand", tcfg), make_sched(tcfg, 0, device="cpu")
    tstate, t1 = tstep(tstate, tb, tsched)
    tgrads = {n: p.grad.clone() for n, p in model.named_parameters()}
    tstate, t2 = tstep(tstate, tb, tsched)
    return jax_run, {"eval": teval, "loss": [floats(t1), floats(t2)], "grads": tgrads, "step": int(tstate.step)}


@pytest.fixture(scope="module")
def runs():
    return step_runs(_slice_batch())


def test_rgb2hm_eval_step(runs):
    ref, out = runs[0]["eval"], runs[1]["eval"]
    assert set(out) == set(ref) and "hm_j2d" in out
    assert out["hm_j2d"].shape == (B, 21, 2)
    for k in ("hm_j2d", "joints", "j2d", "mano_verts", "pose_params", "shape_params"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_rgb2hm_train_step_loss_terms(runs):
    jax_run, port_run = runs
    for step in range(2):
        jl, pl = jax_run["loss"][step], port_run["loss"][step]
        assert set(pl) == set(jl) == set(FIRED) | {"skipped"}
        assert pl["skipped"] == jl["skipped"] == 0.0
        for k in FIRED:
            assert pl[k] != 0.0, k
            rtol = 1e-4 if step == 0 or k == "total" else 1e-2
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, err_msg=f"step {step + 1} {k}")
    assert port_run["step"] == 2


def _zero_in_exact_arithmetic(name: str) -> str | None:
    """The weight beside a bias whose gradient is zero in exact arithmetic,
    so that rounding noise is all either side holds: the heads' Linear
    biases that feed a train-mode BatchNorm, and every conv bias of the
    hourglass. In train mode a per-channel constant added anywhere in
    NetHMHG reaches the heatmaps only through a train-mode BatchNorm, which
    subtracts it (every HGResidual starts with one, max pool and the resize
    carry a constant through, post_bn follows each stack) or through the
    per-joint softmax of heatmaps_to_uv, which ignores it."""
    if name in ZERO_GRAD_BIASES:
        return ZERO_GRAD_BIASES[name]
    if name.startswith("rgb2hm.") and name.endswith(".bias") and "bn" not in name.rsplit(".", 2)[-2]:
        return name[:-len("bias")] + "weight"
    return None


def test_rgb2hm_train_step_gradients(runs):
    jax_run, port_run = runs
    jg, tg = jax_run["grads"], port_run["grads"]
    assert set(jg) == set(tg)
    assert sum(n.startswith("rgb2hm.") for n in tg) > 200  # the hourglass at 32 px: depth 3
    held = 0
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        weight = _zero_in_exact_arithmetic(name)
        if weight is not None:
            scale = np.linalg.norm(jg[weight].numpy())
            assert np.linalg.norm(a) < 1e-6 * scale and np.linalg.norm(b) < 1e-6 * scale, name
        elif not b.any():  # outputs no loss reads: the rot, trans and scale heads
            assert not a.any(), name
        else:
            tol = HOURGLASS_GRAD_TOL if name.startswith("rgb2hm.") else 1e-3
            assert rel_l2(a, b) < tol, (name, rel_l2(a, b))
            held += name.startswith("rgb2hm.")
    assert held > 100
    assert np.linalg.norm(tg["rgb2hm.hm1.weight"].numpy()) > 0


def _small(**over) -> Config:
    return Config(**dict(CFG, render=False, losses=("joint_3d", "hm_integral_gt"), train_batch=8, val_batch=8,
                         num_workers=0, print_freq=1, demo_freq=10000, save_mode="only_latest", **over))


def _synthetic_batch(n: int = 8) -> dict:
    b = nimble_slice_batch(n, S)
    return {k: torch.tensor(b[k]) for k in ("imgs", "Ks", "root_xyz", "joints", "j2d_gt", "verts")}


def test_freeze_hm_estimator_leaves_rgb2hm():
    """freeze_hm_estimator adds rgb2hm to the frozen prefixes (JAX
    train_state.py:79): its parameters take no update, while the rest of
    the model trains and the hourglass's BatchNorm statistics still move."""
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    cfg = _small(freeze_hm_estimator=True)
    model = build_model(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, cfg)
    assert all(not p.requires_grad for n, p in model.named_parameters() if n.startswith("rgb2hm."))
    assert not any(id(p) == id(q) for p in state.optimizer.params
                   for n, q in model.named_parameters() if n.startswith("rgb2hm."))
    state, d = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)(state, _synthetic_batch(),
                                                                          make_sched(cfg, 0, device="cpu"))
    assert d["skipped"].item() == 0.0 and d["hm_integral_gt"].item() > 0
    after = model.state_dict()
    assert all(torch.equal(after[n], before[n]) for n, _ in model.named_parameters() if n.startswith("rgb2hm."))
    assert not torch.equal(after["encoder.backbone.conv1.weight"], before["encoder.backbone.conv1.weight"])
    assert not torch.equal(after["rgb2hm.stem_bn.running_mean"], before["rgb2hm.stem_bn.running_mean"])


def _trainer(cfg: Config, out_dir: str, seed: int = 0):
    from hifihr_tpu_torch.data.base import BatchLoader
    from hifihr_tpu_torch.data.synthetic import SyntheticHandDataset
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.loop import Trainer

    train = BatchLoader(SyntheticHandDataset(size=8, image_size=S), cfg.train_batch)
    return Trainer(cfg, build_model(cfg, device="cpu", seed=seed), train, None, out_dir=out_dir)


def test_pretrain_rgb2hm_restores_only_rgb2hm(tmp_path):
    """The Trainer's pretrain_rgb2hm warm start (loop.py, JAX loop.py:120-123)
    copies the checkpoint's rgb2hm.* parameters and statistics into the
    model, and nothing else."""
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.checkpoint import CheckpointManager
    from hifihr_tpu_torch.training.train_state import create_train_state

    donor = build_model(_small(), device="cpu", seed=1)
    CheckpointManager(str(tmp_path / "ckpt"), "only_latest").save(create_train_state(donor, _small()), 0)
    fresh = build_model(_small(), device="cpu", seed=0).state_dict()
    warm = _trainer(_small(pretrain_rgb2hm=str(tmp_path / "ckpt")), str(tmp_path / "warm"), seed=0)
    got, ref = warm.model.state_dict(), donor.state_dict()
    assert any(not torch.equal(ref[k], fresh[k]) for k in ref if k.startswith("rgb2hm."))
    for k, v in got.items():
        want = ref[k] if k.startswith("rgb2hm.") else fresh[k]
        assert torch.equal(v, want), k
    assert warm.start_epoch == 0


def test_refine_targets_hm_j2d(tmp_path):
    """Trainer._refine fits the MANO parameters to the heatmap branch's 2D
    joints (hm_j2d) when the model outputs them, ahead of the batch's j2d_gt
    (JAX loop.py:219)."""
    from hifihr_tpu_torch.hand.mano import ManoLayer

    trainer = _trainer(_small(test_refinement=True), str(tmp_path))
    batch = _synthetic_batch()
    out = trainer._step_for("FreiHand", train=False)(batch)
    assert "hm_j2d" in out and not torch.equal(out["hm_j2d"], batch["j2d_gt"])
    seen = []

    def fit(pose, betas, trans, scale, Ks, target, conf, root_xyz):
        seen.append(target)
        return {"pose": pose, "betas": betas, "trans": trans, "scale": scale}

    trainer._fit = (ManoLayer(ncomps=45), fit)
    joints, verts = trainer._refine(out, batch)
    assert len(seen) == 1 and torch.equal(seen[0], out["hm_j2d"])
    assert joints.shape == (8, 21, 3) and verts.shape == (8, 778, 3)
