"""HRNet-W18-small-v2 (`pretrain="hr18sv2"`) in the port against the JAX
package, apart from the model's steps (tests/test_torch_hrnet_slice.py):
the encoder alone in eval and train mode, the fuse layer's upsampling, the
init, the imagenet warm start (three and four input channels), one case of
the 1-rank-against-2 harness of tests/test_torch_parallel.py, and
`pretrain="none"`. The weights are drawn in numpy over the shapes of JAX's
init (torch_port_helpers.seeded_variables): the jitted flax init of HRNet
compiles for ~20 s.

Tolerances:
- the encoder's pooled features, fp32, at 64 px and batch 4: in eval mode
  within 1e-5 of their largest value (measured 1.8e-6). In train mode the
  BatchNorms normalise by batch statistics over few values per channel (the
  head's last branch is 2x2 here), and flax's E[x^2] - E[x]^2 variance
  loses digits that torch's kernel keeps: against the same encoder in
  float64, JAX is off by 2.5e-5 of the largest feature and the port by
  1.4e-5 (measured), so the port is held within 5e-5 of JAX (measured
  3.5e-5) and no further from float64 than JAX is; the running statistics
  within 1e-5;
- the init's standard deviations within 5 / sqrt(2n) of flax's scale, and
  flax's own draws within the same of it;
- the warm start: every tensor exactly where JAX's merge puts it;
- 1 rank against 2, one step: the terms within 1e-4, the ranks'
  parameters bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.models.hifihr import HiFiHR as JModel
from hifihr_tpu.networks.hrnet import HRNetEncoder as JEncoder
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax
from hifihr_tpu_torch.models.hifihr import HiFiHR, init_weights
from hifihr_tpu_torch.networks.hrnet import HRNetEncoder
from hifihr_tpu_torch.networks.resnet import StemConv
from hifihr_tpu_torch.parallel.launch import spawn_ranks
from torch_port_helpers import dp_train_rank, seeded_variables, varied_batch
from torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

B, S = 8, 32
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "iou", "bone_direc")
CFG = dict(pretrain="hr18sv2", hand_model="mano", render=True, light_estimation=True, image_size=S,
           aa_factor=3, aa_mode="msaa", compute_dtype="float32", losses=LOSSES, init_lr=1e-3)


@pytest.fixture(scope="module")
def variables():
    """Numpy-drawn variables over the shapes of JAX's hr18sv2 init at 32 px
    (torch_port_helpers.seeded_variables)."""
    jm = JModel(config=JConfig(**CFG))
    return seeded_variables(jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False),
                                           jnp.zeros((1, S, S, 3))), 0)


@pytest.fixture(scope="module")
def encoder_pair():
    """JAX's HRNetEncoder at 64 px, batch 4, with seeded variables, and the
    port's encoder holding them (and a float64 copy)."""
    imgs = np.random.RandomState(3).rand(4, 64, 64, 3).astype(np.float32)
    jenc = JEncoder()
    shapes = jax.eval_shape(lambda x: jenc.init(jax.random.PRNGKey(2), x, train=False), jnp.asarray(imgs))
    v = seeded_variables({"params": {"encoder": shapes["params"]}, "batch_stats": {"encoder": shapes["batch_stats"]}},
                         3)
    sd = {k[len("encoder."):]: x for k, x in state_dict_from_flax(v).items()}
    enc, enc64 = HRNetEncoder(), HRNetEncoder().double()
    enc.load_state_dict(sd, strict=True)
    enc64.load_state_dict(sd, strict=True)
    jv = {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]}
    return jenc, jv, enc, enc64, imgs


@pytest.mark.parametrize("train", [False, True])
def test_hrnet_encoder(encoder_pair, train):
    jenc, jv, enc, enc64, imgs = encoder_pair
    if train:
        (jlow, jfeat), upd = jax.jit(lambda v, x: jenc.apply(v, x, train=True, mutable=["batch_stats"]))(
            jv, jnp.asarray(imgs))
    else:
        jlow, jfeat = jax.jit(lambda v, x: jenc.apply(v, x, train=False))(jv, jnp.asarray(imgs))
    enc.train(train)
    enc64.train(train)
    with torch.no_grad():
        low, feat = enc(torch.tensor(imgs))
        feat64 = enc64(torch.tensor(imgs, dtype=torch.float64))[1].numpy()
    assert jlow is None and low is None
    assert feat.shape == (4, 1024) and feat.dtype == torch.float32
    ref = np.asarray(jfeat)
    top = np.abs(ref).max()
    err = np.abs(feat.numpy() - ref).max() / top
    assert err < (5e-5 if train else 1e-5), err
    if train:
        assert np.abs(feat.numpy() - feat64).max() <= np.abs(ref - feat64).max()
        stats = state_dict_from_flax({"params": {}, "batch_stats": {"encoder": upd["batch_stats"]}})
        for k, x in enc.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(x.numpy(), stats[f"encoder.{k}"].numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=k)


def test_hrnet_upsampling_samples_half_pixel_centres():
    """The fuse layer's upsampling is jax.image.resize's "nearest" (half-pixel
    centres), also at a non-integer ratio, where torch's "nearest" differs."""
    import torch.nn.functional as Fn

    x = np.random.RandomState(4).rand(1, 5, 7, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 12, 9, 3), "nearest"))
    got = Fn.interpolate(torch.tensor(x).permute(0, 3, 1, 2), size=(12, 9), mode="nearest-exact")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_hrnet_init_distributions(variables):
    """init_weights draws HRNet's convs as flax does: the s2d stem
    variance_scaling(2, fan_out) over its (2, 2, 12, 64) shape, every other
    conv lecun_normal (fan_in = C_in k^2), truncated at 2 sigma; BatchNorm
    scales 1 and biases 0. Each conv is held against the analytic scale, and
    the scale against a draw of flax's own initialiser at the first conv of
    each kind (the stem, 1x1, 3x3)."""
    from flax import linen as fnn

    jsd = state_dict_from_flax(variables)
    model = init_weights(HiFiHR(Config(**CFG)), seed=5)
    convs = {n: m for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)}
    assert sum(isinstance(m, StemConv) for m in convs.values()) == 1
    assert len(convs) == sum(x.ndim == 4 for x in jsd.values())
    flax_draws = {}
    for name, m in convs.items():
        w = m.weight.detach()
        n = w.numel()
        stem = isinstance(m, StemConv)
        shape = (2, 2, 12, 64) if stem else tuple(w.permute(2, 3, 1, 0).shape)
        want = (2.0 / (2 * 2 * 64)) ** 0.5 if stem else (1.0 / w[0].numel()) ** 0.5
        tol = 5 / (2 * n) ** 0.5
        assert abs(w.std().item() / want - 1) < tol, (name, w.std().item(), want)
        kind = "stem" if stem else shape[0]  # flax's draw for the first conv of each kind
        if kind not in flax_draws:
            init = (fnn.initializers.variance_scaling(2.0, "fan_out", "truncated_normal") if stem
                    else fnn.initializers.lecun_normal())
            flax_draws[kind] = float(np.asarray(init(jax.random.PRNGKey(len(flax_draws)), shape)).std())
            assert abs(flax_draws[kind] / want - 1) < tol, (name, flax_draws[kind], want)
        assert w.abs().max().item() <= 2 * want / 0.87962566103423978 * (1 + 1e-6), name
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            assert torch.all(m.weight == 1) and not m.bias.any(), name


@pytest.mark.parametrize("four_channel", [False, True])
def test_hrnet_imagenet_warm_start(variables, tmp_path, four_channel):
    """A flax-layout imagenet_hr18sv2.npz (keys 'params/<backbone path>/...'
    and 'batch_stats/...', as tools/convert_torch_weights.py::convert_hrnet
    writes them) made from seeded variables, merged by path suffix into
    other variables by both packages: the same tensors land in the same
    places. Over four channels the 3-channel stem is skipped by shape, as
    JAX's merge_npz_into_variables skips it."""
    from flax import traverse_util

    from hifihr_tpu.utils.weights import merge_npz_into_variables
    from hifihr_tpu_torch.utils.weights import merge_npz_into_model

    flat = {}
    for kind in ("params", "batch_stats"):
        tree = traverse_util.flatten_dict(variables[kind]["encoder"]["backbone"], sep="/")
        flat.update({f"{kind}/{k}": np.asarray(x) + 0.25 for k, x in tree.items()})
    npz = str(tmp_path / "imagenet_hr18sv2.npz")
    np.savez(npz, **flat)

    fresh = {k: traverse_util.unflatten_dict({p: np.asarray(x) - 0.5 for p, x in
                                              traverse_util.flatten_dict(t).items()}) for k, t in variables.items()}
    if four_channel:  # the stem over the heatmap channel too
        fresh["params"]["encoder"]["backbone"]["conv1"]["kernel"] = np.random.RandomState(1).randn(
            2, 2, 16, 64).astype(np.float32)
    merged = merge_npz_into_variables(npz, fresh)
    model = HiFiHR(Config(**dict(CFG, four_channel=four_channel)))
    model.load_state_dict(state_dict_from_flax(fresh), strict=True)
    copied = merge_npz_into_model(npz, model)
    got = model.state_dict()
    for k, x in state_dict_from_flax(merged).items():
        torch.testing.assert_close(got[k], x, rtol=0, atol=0, msg=k)
    stem = got["encoder.backbone.conv1.weight"]
    assert stem.shape[1] == (4 if four_channel else 3)
    from_npz = state_dict_from_flax({"params": {"encoder": {"backbone": {"conv1": {
        "kernel": flat["params/conv1/kernel"]}}}}})["encoder.backbone.conv1.weight"]
    assert torch.equal(from_npz, stem) is not four_channel
    assert copied == len(flat) - (1 if four_channel else 0)


def test_pretrain_none_raises_as_jax():
    """Config(pretrain="none") builds in both packages; both models raise
    ValueError("none")."""
    cfg = dict(CFG, pretrain="none")
    jm = JModel(config=JConfig(**cfg))
    with pytest.raises(ValueError, match="none"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=False)
    with pytest.raises(ValueError, match="none"):
        HiFiHR(Config(**cfg))


def test_hr18sv2_one_rank_against_two(tmp_path):
    """The hr18sv2 train step at one rank and at two gloo ranks on the same
    global batch (tests/test_torch_parallel.py's harness, one step): the
    global BatchNorm makes HRNet's every statistic the whole batch's, so the
    terms agree within 1e-4 and the ranks' parameters bit for bit."""
    cfg = dict(CFG, losses=LOSSES + ("open_2dj",))
    batch = varied_batch(B, S)
    one = dp_train_rank(0, 1, "cpu", cfg, batch, steps=1)
    two = spawn_ranks(dp_train_rank, 2, (cfg, batch, 1, 1), backend="gloo", device="cpu", timeout_s=300,
                      collective_timeout_s=120, workdir=str(tmp_path))
    for r in two:
        assert r["step"] == 1
        torch.testing.assert_close(r["flat"], two[0]["flat"], rtol=0, atol=0)
        got, want = r["losses"][0], one["losses"][0]
        assert set(got) == set(want) and got["skipped"] == want["skipped"] == 0.0
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert not torch.equal(two[0]["flat"], one["flat0"])
