"""The `four_channel` input in the port against the JAX package: the images
carry a fourth channel, the keypoint heatmap the FreiHAND loader appends
from the openpose detections (`data/freihand.py::keypoint_heatmap_channel`).

- `normalize_imagenet` over 4 channels (the 4th at mean 0.5, std 1.0);
- the stems over 4 channels of the three encoders (ResNet-18, EfficientNet-
  b3, HRNet), each encoder in eval mode, fp32, against JAX's from the same
  variables;
- a train step under the loss set JAX runs with four channels (res18,
  32 px, batch 8, the flagship's geometric terms and open_2dj, no
  `segms_gt` or `texture_con` in the batch);
- the port raising where JAX raises. JAX's photometric terms compare the
  3-channel render against the 4-channel images (`segms_gt[..., None] *
  imgs` and `maskRGBs`, hifihr_tpu/losses/stack.py:184-214), and so do the
  Trainer's texture metrics (hifihr_tpu/training/loop.py:301): any batch
  with `segms_gt` or `texture_con` makes JAX's step raise TypeError at
  trace time, and the port's raises RuntimeError at the same subtraction.
  The port adds no slicing of its own.

The JAX step is jitted; no loss reads the render in this step, so XLA
drops JAX's face choice, and the port's step renders its own. The weights
are drawn in numpy over the shapes of JAX's init
(torch_port_helpers.seeded_variables).

Tolerances: the normalisation to 1e-6; the encoders' features within 1e-5
of their largest value; the train step's terms
within 1e-4 relative (the slice tests'); its gradients within 1e-3
relative L2, except below layer4_0.bn1, where 2e-3: layer4 runs at 2x2 at
32 px, and the train-mode BatchNorm backward of layer4_0.bn1 over 8 x 2 x 2
values per channel adds a 1.2e-3 relative difference (measured 1.0e-3 to
1.6e-3 on every tensor from its bias down to the stem, against 7.6e-5 at
most above it; JAX's own gradients move by 3e-5 under one ulp of input,
which does not reach that BatchNorm's rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.losses.stack import LossComputer as JLossComputer
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.training.steps import make_sched as jmake_sched
from hifihr_tpu.training.steps import make_train_step as jmake_train_step
from hifihr_tpu.training.train_state import TrainState as JTrainState
from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.data.freihand import keypoint_heatmap_channel
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.models.hifihr import HiFiHR
from hifihr_tpu_torch.training.steps import make_sched, make_train_step
from hifihr_tpu_torch.training.train_state import create_train_state
from torch_port_helpers import fake_K, rel_l2, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

B, S = 8, 32
# the flagship's losses that read no render, and the heatmap's detections
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "bone_direc", "open_2dj")
CFG = dict(pretrain="res18", hand_model="mano", render=True, light_estimation=False, image_size=S,
           aa_factor=3, aa_mode="msaa", compute_dtype="float32", losses=LOSSES, init_lr=1e-3, four_channel=True)
ZERO_GRAD_BIASES = {"hand_encoder.base_fc0.bias": "hand_encoder.base_fc0.weight",
                    "hand_encoder.base_fc1.bias": "hand_encoder.base_fc1.weight"}
# the encoder below layer4_0.bn1 (the module docstring)
STEM_SIDE = ("encoder.backbone.conv1", "encoder.backbone.bn1", "encoder.backbone.layer1_",
             "encoder.backbone.layer2_", "encoder.backbone.layer3_", "encoder.backbone.layer4_0.conv1",
             "encoder.backbone.layer4_0.bn1.bias")


def four_channel_batch(n: int = B, size: int = S, photometric: bool = False) -> dict:
    """The slice tests' batch with seeded openpose detections and their
    heatmap channel appended to the images, as the FreiHAND loader appends
    it; `segms_gt` and `texture_con` only when `photometric`."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(n, size, size, 3).astype(np.float32)
    open_2dj = (rng.rand(n, 21, 2) * size).astype(np.float32)
    hm = np.stack([keypoint_heatmap_channel(j, size) for j in open_2dj])[..., None]
    b = {
        "imgs": np.concatenate([imgs, hm], -1),
        "Ks": fake_K(n, size),
        "root_xyz": np.tile(np.asarray([[[0.0, 0.0, 0.5]]], np.float32), (n, 1, 1)),
        "joints": (rng.randn(n, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "j2d_gt": (rng.rand(n, 21, 2) * size).astype(np.float32),
        "verts": (rng.randn(n, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "open_2dj": open_2dj,
        "open_2dj_con": rng.uniform(0.2, 1.0, (n, 21, 1)).astype(np.float32),
        "scales": np.full((n,), 0.0282, np.float32),
    }
    if photometric:
        b["segms_gt"] = (rng.rand(n, size, size) > 0.6).astype(np.float32)
        b["texture_con"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
    return b


def test_normalize_imagenet_four_channels():
    from hifihr_tpu.networks.resnet import normalize_imagenet as jnorm
    from hifihr_tpu_torch.networks.resnet import normalize_imagenet

    x = np.random.RandomState(1).rand(2, 8, 8, 4).astype(np.float32)
    ref = np.asarray(jnorm(jnp.asarray(x)))
    out = normalize_imagenet(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[..., 3], x[..., 3] - 0.5, rtol=0, atol=1e-7)


@pytest.mark.parametrize("pretrain", ["res18", "effb3", "hr18sv2"])
def test_four_channel_encoder(pretrain):
    """The encoder over four channels (its s2d stem a (M, M, 16, O) kernel),
    eval mode, fp32, at 32 px (64 for effb3, whose low tap needs it)."""
    from hifihr_tpu.networks.efficientnet import EffNetEncoder as JEff
    from hifihr_tpu.networks.hrnet import HRNetEncoder as JHR
    from hifihr_tpu.networks.resnet import ResNetEncoder as JRes

    size = 64 if pretrain == "effb3" else S
    jenc = {"res18": lambda: JRes(variant="res18"), "effb3": JEff, "hr18sv2": JHR}[pretrain]()
    imgs = np.random.RandomState(2).rand(2, size, size, 4).astype(np.float32)
    shapes = jax.eval_shape(lambda x: jenc.init(jax.random.PRNGKey(0), x, train=False), jnp.asarray(imgs))
    v = seeded_variables({"params": {"encoder": shapes["params"]}, "batch_stats": {"encoder": shapes["batch_stats"]}},
                         4)
    jv = {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]}
    jlow, jfeat = jax.jit(lambda v, x: jenc.apply(v, x, train=False))(jv, jnp.asarray(imgs))
    model = HiFiHR(Config(pretrain=pretrain, render=False, light_estimation=False, image_size=size,
                          compute_dtype="float32", four_channel=True))
    stem = "encoder.backbone.conv_stem.weight" if pretrain == "effb3" else "encoder.backbone.conv1.weight"
    assert model.state_dict()[stem].shape[1] == 4
    sd = {k[len("encoder."):]: x for k, x in state_dict_from_flax(v).items()}
    model.encoder.load_state_dict(sd, strict=True)
    model.eval()
    with torch.no_grad():
        low, feat = model.encoder(torch.tensor(imgs))
    ref = np.asarray(jfeat, np.float32)
    np.testing.assert_allclose(feat.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if jlow is None:
        assert low is None
    else:
        jl = np.asarray(jlow, np.float32)
        np.testing.assert_allclose(low.permute(0, 2, 3, 1).numpy(), jl, rtol=0, atol=1e-5 * np.abs(jl).max())


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def step_runs() -> tuple:
    """One train step of each package from the same weights: (JAX's run,
    the port's run). No loss reads the render, so XLA drops JAX's face
    choice and the port's step renders its own."""
    batch = four_channel_batch()
    jcfg = JConfig(**CFG)
    jm = JModel(config=jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = seeded_variables(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False), jb["imgs"]), 0)
    state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=jmake_optimizer(jcfg, 1000),
                               batch_stats=v["batch_stats"])
    state, d = jmake_train_step(jm, JLossComputer(jcfg), "FreiHand", jcfg)(state, jb, jmake_sched(jcfg, 0))
    jax_run = {"loss": _floats(d), "grads": state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)})}

    cfg = Config(**CFG)
    model = HiFiHR(cfg)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    tb = {k: torch.tensor(x) for k, x in batch.items()}
    tstate = create_train_state(model, cfg)
    tstate, d = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)(tstate, tb, make_sched(cfg, 0, "cpu"))
    port_run = {"loss": _floats(d), "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
    return jax_run, port_run


@pytest.fixture(scope="module")
def runs():
    return step_runs()


def test_four_channel_train_step(runs):
    jax_run, port_run = runs
    jl, pl = jax_run["loss"], port_run["loss"]
    assert set(pl) == set(jl) == set(LOSSES) | {"total", "skipped"}
    assert pl["skipped"] == jl["skipped"] == 0.0
    for k in LOSSES + ("total",):
        np.testing.assert_allclose(pl[k], jl[k], rtol=1e-4, err_msg=k)
    jg, tg = jax_run["grads"], port_run["grads"]
    assert set(jg) == set(tg) and tg["encoder.backbone.conv1.weight"].shape[1] == 4
    assert tg["encoder.backbone.conv1.weight"][:, 3].abs().sum() > 0  # the heatmap channel learns
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        if name in ZERO_GRAD_BIASES:
            scale = np.linalg.norm(jg[ZERO_GRAD_BIASES[name]].numpy())
            assert np.linalg.norm(a) < 1e-6 * scale and np.linalg.norm(b) < 1e-6 * scale, name
        elif not b.any():  # outputs no loss reads (the render's albedo among them)
            assert not a.any(), name
        else:
            # every tensor from layer4_0.bn1 down to the stem carries the
            # relative error its train-mode BatchNorm's backward adds
            tol = 2e-3 if name.startswith(STEM_SIDE) else 1e-3
            assert rel_l2(a, b) < tol, (name, rel_l2(a, b))


@pytest.mark.parametrize("keys", [("segms_gt",), ("texture_con",)])
def test_four_channel_raises_where_jax_raises(keys):
    """A batch with a photometric target: JAX's step raises TypeError while
    tracing (the 3-channel render against the 4-channel images), the port's
    RuntimeError at the same subtraction."""
    batch = four_channel_batch(2, photometric=True)
    for k in ("segms_gt", "texture_con"):
        if k not in keys:
            del batch[k]
    losses = LOSSES + (("sil",) if "segms_gt" in keys else ())
    jcfg = JConfig(**dict(CFG, losses=losses))
    jm = JModel(config=jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False), jb["imgs"])
    state = JTrainState.create(apply_fn=jm.apply, params=shapes["params"], tx=jmake_optimizer(jcfg, 10),
                               batch_stats=shapes["batch_stats"])
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(jmake_train_step(jm, JLossComputer(jcfg), "FreiHand", jcfg), state, jb, jmake_sched(jcfg, 0))

    cfg = Config(**dict(CFG, losses=losses))
    model = HiFiHR(cfg)
    step = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)
    with pytest.raises(RuntimeError, match="size of tensor"):
        step(create_train_state(model, cfg), {k: torch.tensor(x) for k, x in batch.items()},
             make_sched(cfg, 0, "cpu"))


def test_four_channel_texture_metrics_raise_as_jax():
    """The Trainer's eval texture metrics read the images beside the render:
    both packages raise on four channels."""
    from hifihr_tpu.training import metrics as jmetrics
    from hifihr_tpu_torch.training import metrics

    re_img, re_sil = np.zeros((2, S, S, 3), np.float32), np.zeros((2, S, S, 1), np.float32)
    imgs, mask = np.zeros((2, S, S, 4), np.float32), np.zeros((2, S, S), np.float32)
    with pytest.raises(TypeError):
        jmetrics.texture_metrics(jnp.asarray(re_img), jnp.asarray(re_sil), jnp.asarray(imgs),
                                 gt_mask=jnp.asarray(mask))
    with pytest.raises(RuntimeError):
        metrics.texture_metrics(torch.tensor(re_img), torch.tensor(re_sil), torch.tensor(imgs),
                                gt_mask=torch.tensor(mask))
