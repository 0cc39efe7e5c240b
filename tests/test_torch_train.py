"""Train mode and the optimizer of the port against flax and optax (CPU,
fp32), and the train step's own guarantees.

Tolerances: BatchNorm outputs and running statistics at 1e-5 (fp32 batch
statistics reduced in another order; the port takes the biased variance as
invstd^-2 - eps from the normalising kernel, flax as E[x^2] - E[x]^2);
Adam, AdamW and the learning rate at rtol 1e-6 (the same fp32 formulas,
rounded in another order); the skip guard, freezing and the eval step after
a train step exactly.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.networks.resnet import StemConvS2D
from hifihr_tpu.training.train_state import freeze_submodules as jfreeze
from hifihr_tpu.training.train_state import make_lr_schedule as jmake_lr_schedule
from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.models.hifihr import HiFiHR, build_model
from hifihr_tpu_torch.networks.batchnorm import BatchNorm1d, BatchNorm2d
from hifihr_tpu_torch.networks.heads import HandEncoder
from hifihr_tpu_torch.networks.resnet import StemConv
from hifihr_tpu_torch.training.steps import make_eval_step, make_sched, make_train_step
from hifihr_tpu_torch.training.train_state import (Adam, create_train_state, freeze_submodules,
                                                   make_lr_schedule)
from torch_port_helpers import fake_K

B, S = 2, 32
SMALL = dict(pretrain="res18", hand_model="mano", render=True, light_estimation=False, image_size=S,
             aa_factor=3, aa_mode="msaa", compute_dtype="float32",
             losses=("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "iou",
                     "bone_direc"))


def test_config_fields_default_as_jax():
    """Every field of the port's Config has the JAX Config's name and
    default, and the stepped lambdas step alike."""
    import dataclasses

    for f in dataclasses.fields(Config):
        assert getattr(Config(), f.name) == getattr(JConfig(), f.name), f.name
    steps = dict(lambda_pose_list=(1e-4, 1e-3, 1e-2), lambda_pose_steps=(2, 5))
    for epoch in range(7):
        assert Config(**steps).lambda_at_epoch("pose", epoch) == JConfig(**steps).lambda_at_epoch("pose", epoch)
    for bad in (dict(optimizer="SGD"), dict(base_loss_fn="L3"), dict(lambda_shape_list=(1.0, 2.0))):
        with pytest.raises(ValueError):
            Config(**bad)


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("dims", [1, 2])
def test_batchnorm_matches_flax_train_mode(batch, dims):
    """Three train-mode updates: outputs, parameter gradients, and the
    running mean and (biased) variance after each; the input gradient at
    batch 8. At batch 2 each normalised pair is about +-1 whatever x is, so
    the input gradient is a near-total cancellation that both packages round
    differently (flax's own pair is antisymmetric only to 1e-3)."""
    rng = np.random.RandomState(batch + dims)
    shape = (3, batch, 6) if dims == 1 else (3, batch, 5, 5, 6)
    x = (rng.randn(*shape) * 2.0 + 0.7).astype(np.float32)
    scale = (rng.rand(6) + 0.5).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    ct = rng.randn(*shape[1:]).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    stats = bn.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))["batch_stats"]
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tbn = BatchNorm1d(6) if dims == 1 else BatchNorm2d(6)
    with torch.no_grad():
        tbn.weight.copy_(torch.tensor(scale))
        tbn.bias.copy_(torch.tensor(bias))
    tbn.train()

    def to_port(a):
        return torch.tensor(a) if dims == 1 else torch.tensor(a).permute(0, 3, 1, 2)

    def from_port(t):
        return t.detach().numpy() if dims == 1 else t.detach().permute(0, 2, 3, 1).numpy()

    for i in range(3):
        def f(p, xi):
            y, mut = bn.apply({"params": p, "batch_stats": stats}, xi, mutable=["batch_stats"])
            return jnp.sum(y * ct), (y, mut)

        (gp, gx), (y, mut) = jax.grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x[i]))
        stats = mut["batch_stats"]
        xt = to_port(x[i]).requires_grad_()
        tbn.zero_grad()
        yt = tbn(xt)
        (yt * to_port(ct)).sum().backward()
        np.testing.assert_allclose(from_port(yt), np.asarray(y), atol=1e-5)
        if batch > 2:
            np.testing.assert_allclose(from_port(xt.grad), np.asarray(gx), atol=1e-5)
        np.testing.assert_allclose(tbn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tbn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)
    # eval mode normalises with the running statistics, as flax's
    # use_running_average=True does
    tbn.eval()
    ref = fnn.BatchNorm(use_running_average=True).apply({"params": params, "batch_stats": stats},
                                                        jnp.asarray(x[0]))
    np.testing.assert_allclose(from_port(tbn(to_port(x[0]))), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_adam_and_lr_schedule_match_optax(optimizer):
    """Six updates across two learning-rate boundaries (epochs 1 and 2 at
    two steps per epoch) on the same gradient sequence."""
    cfg = dict(optimizer=optimizer, init_lr=1e-3, lr_steps=(1, 2), lr_gamma=0.1)
    jcfg, tcfg = JConfig(**cfg), Config(**cfg)
    rng = np.random.RandomState(0)
    shapes = {"w": (4, 3), "b": (3,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-3, 2)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]

    tx = jmake_optimizer(jcfg, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    tp = {k: nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    params = nn.ParameterDict(tp)
    order = [n for n, _ in params.named_parameters()]  # the flat buffer's order
    state_opt = create_train_state(params, tcfg, steps_per_epoch=2).optimizer
    for i, g in enumerate(grads):
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        state_opt.zero_grad()
        for k, v in g.items():
            tp[k].grad.copy_(torch.tensor(v))
        state_opt.step(torch.tensor(True))
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9,
                                       err_msg=f"{k} after step {i + 1}")
        np.testing.assert_allclose(state_opt.mu.numpy(),
                                   np.concatenate([np.asarray(js[0].mu[k]).ravel() for k in order]), rtol=1e-6)
    assert int(state_opt.count) == 6

    jsched = jmake_lr_schedule(JConfig(**cfg, force_init_lr=5e-4), 2)
    tsched = make_lr_schedule(Config(**cfg, force_init_lr=5e-4), 2)
    lrs = [float(tsched(torch.tensor(k, dtype=torch.int32))) for k in range(8)]
    np.testing.assert_allclose(lrs, [float(jsched(k)) for k in range(8)], rtol=1e-6)
    assert lrs[1] == pytest.approx(5e-4) and lrs[2] == pytest.approx(5e-5) and lrs[4] == pytest.approx(5e-6)


def test_freeze_submodules_matches_optax_multi_transform():
    """Frozen prefixes (flax '/' paths) get no update; the rest get Adam's,
    as optax.multi_transform with set_to_zero gives them."""
    model = nn.Module()
    model.hand_encoder = HandEncoder(16)
    model.vert_tex = nn.Parameter(torch.randn(778, 3))
    prefixes = ("hand_encoder/base", "hand_encoder/pose", "vert_tex")
    rng = np.random.RandomState(1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: rng.randn(*p.shape).astype(np.float32) for n, p in model.named_parameters()}

    def tree(flat):
        out = {}
        for n, v in flat.items():
            node = out
            *path, leaf = n.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(np.asarray(v))
        return out

    jparams = tree(before)
    tx = jfreeze(optax.adam(1e-3), jparams, prefixes)
    upd, _ = tx.update(tree(grads), tx.init(jparams), jparams)
    jnew = optax.apply_updates(jparams, upd)

    trained = freeze_submodules(model, prefixes)
    opt = Adam(trained, lambda count: torch.tensor(1e-3))
    opt.zero_grad()
    for n, p in model.named_parameters():
        if p.requires_grad:
            p.grad.copy_(torch.tensor(grads[n]))
    opt.step(torch.tensor(True))
    n_frozen = 0
    for n, p in model.named_parameters():
        node = jnew
        for k in n.split("."):
            node = node[k]
        frozen = any(n.replace(".", "/").startswith(pre) for pre in prefixes)
        n_frozen += frozen
        assert p.requires_grad != frozen
        if frozen:
            assert torch.equal(p.detach(), before[n])
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(node), rtol=1e-6, atol=1e-9, err_msg=n)
    assert 0 < n_frozen < len(before)


def _small_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "imgs": torch.tensor(rng.rand(B, S, S, 3).astype(np.float32)),
        "Ks": torch.tensor(fake_K(B, S)),
        "root_xyz": torch.tensor([[[0.0, 0.0, 0.5]]]).repeat(B, 1, 1),
        "joints": torch.tensor((rng.randn(B, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32)),
        "j2d_gt": torch.tensor((rng.rand(B, 21, 2) * S).astype(np.float32)),
        "verts": torch.tensor((rng.randn(B, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32)),
        "segms_gt": torch.tensor((rng.rand(B, S, S) > 0.6).astype(np.float32)),
        "texture_con": torch.ones(B),
    }


def _bn_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def test_skip_guard_is_an_exact_no_op_on_params_moments_and_step():
    """A NaN batch and a batch whose loss is under 1e-10 leave the
    parameters, both Adam moments and the step count bit-for-bit as they
    were, while the BatchNorm running stats take the batch's update (the
    port's twin of tests/test_training.py's skip test)."""
    cfg = Config(**SMALL)
    model = build_model(cfg, device="cpu", seed=0)
    state = create_train_state(model, cfg)
    sched = make_sched(cfg, 0, device="cpu")
    step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    batch = _small_batch()
    state, d = step(state, batch, sched)
    assert float(d["skipped"]) == 0.0 and int(state.step) == 1

    zero_cfg = Config(**{**SMALL, "losses": ("mshape",)})
    zero_step = make_train_step(model, LossComputer(zero_cfg), "FreiHand", zero_cfg)
    no_photo = {k: v for k, v in batch.items() if k not in ("segms_gt", "texture_con")}
    cases = [
        (step, dict(batch, joints=batch["joints"] * float("nan")), sched, lambda t: torch.isnan(t)),
        (zero_step, no_photo, dict(sched, lambda_shape=torch.tensor(0.0)), lambda t: t == 0.0),
    ]
    for fn, bad, sch, total_is in cases:
        opt = state.optimizer
        before = [t.clone() for t in (opt.flat, opt.mu, opt.nu, opt.count)]
        stats = _bn_stats(model)
        state, d = fn(state, bad, sch)
        assert total_is(d["total"]) and float(d["skipped"]) == 1.0
        for a, b in zip(before, (opt.flat, opt.mu, opt.nu, opt.count)):
            assert torch.equal(a, b)
        after = _bn_stats(model)
        assert all(torch.isfinite(v).all() for v in after.values())
        assert any(not torch.equal(stats[k], after[k]) for k in stats)
    state, d = step(state, batch, sched)  # a good step still trains
    assert float(d["skipped"]) == 0.0 and int(state.step) == 2 and torch.isfinite(state.optimizer.flat).all()


def test_eval_step_after_train_step_equals_a_fresh_eval_step():
    """make_eval_step built before a train step, called after it, runs in
    eval mode: its outputs equal a fresh model's with the same state."""
    cfg = Config(**SMALL)
    model = build_model(cfg, device="cpu", seed=1)
    eval_step = make_eval_step(model, "FreiHand", cfg)
    state = create_train_state(model, cfg)
    step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    batch = _small_batch(1)
    step(state, batch, make_sched(cfg, 0, device="cpu"))
    assert model.training
    inputs = {k: batch[k] for k in ("imgs", "Ks", "root_xyz")}
    out = eval_step(inputs)
    fresh = HiFiHR(cfg)
    fresh.load_state_dict(model.state_dict())
    ref = make_eval_step(fresh, "FreiHand", cfg)(inputs)
    assert not model.training and set(out) == set(ref)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def test_constants_made_under_inference_mode_serve_autograd():
    """The eval step runs under inference_mode and may make a cached device
    constant first; the train step's autograd must still be able to save it."""
    from hifihr_tpu_torch import constant

    with torch.inference_mode():
        idx = constant([3, 1, 4, 1, 5, 9, 2, 6], "cpu", torch.int64)  # values no other caller uses
    assert not idx.is_inference()
    x = torch.randn(2, 10, requires_grad=True)
    x.index_select(1, idx).sum().backward()
    assert x.grad.sum().item() == 16.0


def test_convert_maps_a_flax_gradient_tree():
    """The stem relayout is a permutation, so the s2d kernel's gradient
    converts to the 8x8 weight's gradient; Dense and BatchNorm leaves map
    as their parameters do."""
    rng = np.random.RandomState(2)
    w2 = rng.randn(4, 4, 12, 64).astype(np.float32) * 0.1
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    ct = rng.randn(2, 16, 16, 64).astype(np.float32)
    g = jax.grad(lambda k: jnp.sum(StemConvS2D(64).apply({"params": {"kernel": k}}, jnp.asarray(x)) * ct))(
        jnp.asarray(w2))
    tree = {"encoder": {"backbone": {"conv1": {"kernel": np.asarray(g)}}},
            "hand_encoder": {"base_fc0": {"kernel": np.ones((3, 2), np.float32)},
                             "base_bn0": {"scale": np.ones(2, np.float32)}}}
    sd = state_dict_from_flax({"params": tree})
    stem = StemConv()
    with torch.no_grad():
        stem.weight.copy_(state_dict_from_flax({"params": {"encoder": {"backbone": {"conv1": {"kernel": w2}}}}})[
            "encoder.backbone.conv1.weight"])
    (stem(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1) * torch.tensor(ct)).sum().backward()
    ref = sd["encoder.backbone.conv1.weight"].numpy()
    np.testing.assert_allclose(stem.weight.grad.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert sd["hand_encoder.base_fc0.weight"].shape == (2, 3)
    assert set(sd) == {"encoder.backbone.conv1.weight", "hand_encoder.base_fc0.weight",
                       "hand_encoder.base_bn0.weight"}
