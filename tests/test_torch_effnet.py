"""The port's EfficientNet-b3 (hifihr_tpu_torch/networks/efficientnet.py), its
stem, the 32-channel light-estimator branch, the converter and the seeded
init against the JAX package's, on the same numpy inputs and converted
weights (CPU).

Tolerances:
- fp32: MBConv outputs, running statistics and gradients within 1e-5
  relative to the largest value (fp32 sums in another order); the whole
  encoder at 224^2, batch 2, within 1e-5 relative to the largest value
  (measured 3.5e-7 on `low`, 2.8e-7 on `feat`); the model's heads and
  light estimator from the converted weights within 1e-4, as the ResNet-50
  test holds them;
- bf16 (JAX's EffNetEncoder(dtype=bfloat16) against the port's encoder
  under bf16 autocast): relative L2 within 1e-2 for `low` and `feat`
  (measured 4.6e-3 and 1.5e-3). bf16 keeps 8 bits, and the two sides round
  at different points: flax's swish and BatchNorm output round each
  operation to bf16, torch's silu rounds once;
- init: each encoder conv's sample standard deviation within 5 / sqrt(2n)
  of flax's (n weights), and no weight beyond flax's 2-sigma cut.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.networks import efficientnet as jeff
from hifihr_tpu.networks.heads import LightEstimator as JLightEstimator
from hifihr_tpu.networks.resnet import StemConvS2D
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.convert import state_dict_from_flax, stem_kernel_from_s2d
from hifihr_tpu_torch.networks import efficientnet as teff
from hifihr_tpu_torch.networks.heads import LightEstimator
from hifihr_tpu_torch.networks.resnet import StemConv
from torch_port_helpers import numpy_tree, rel_l2


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _random_stats(v: dict, seed: int) -> dict:
    """Random BatchNorm running statistics, scales and biases, so every
    converted tensor matters."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        for k, x in tree.items():
            if hasattr(x, "items"):
                walk(x)
            elif k in ("mean", "bias"):
                tree[k] = (rng.randn(*x.shape) * 0.1).astype(np.float32)
            elif k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    v = numpy_tree(v)
    walk(v)
    return v


def _close(a, b, tol=1e-5, what=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30), err_msg=what)


def test_same_padding():
    """flax's SAME: the low side gets the smaller half."""
    assert teff.same_pad(112, 3, 2) == (0, 1) and teff.same_pad(56, 5, 2) == (1, 2)
    assert teff.same_pad(13, 3, 2) == (1, 1) and teff.same_pad(2, 5, 2) == (1, 2)
    assert teff.same_pad(14, 5, 1) == (2, 2) and teff.same_pad(14, 3, 1) == (1, 1)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("expand", [1, 6])
@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_mbconv(stride, kernel, expand, train):
    """One MBConv block on a (4, 14, 13, C) input (an even and an odd side, so
    SAME pads asymmetrically at stride 2): its output, in train mode the
    running statistics after one update at momentum 0.99 (the biased batch
    variance) and the gradients of a seeded linear loss with respect to the
    input and every parameter. in == out at stride 1, so the residual is
    held too."""
    cin, cout = 16, 16 if stride == 1 else 24
    x = np.random.RandomState(stride * 100 + kernel * 10 + expand).randn(4, 14, 13, cin).astype(np.float32)
    jm = jeff.MBConv(cin, cout, expand, stride, kernel)
    v = _random_stats(jm.init(jax.random.PRNGKey(kernel), jnp.asarray(x)), seed=expand)
    cot = np.random.RandomState(7).randn(*jm.apply(v, jnp.asarray(x)).shape).astype(np.float32)

    def jloss(params, xx):
        out, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, xx, train=train,
                            mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd)

    (_, (jout, jupd)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))

    tm = teff.MBConv(cin, cout, expand, stride, kernel)
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    tm.train(train)
    tx = _t(x.transpose(0, 3, 1, 2), grad=True)
    out = tm(tx)
    (out * _t(cot.transpose(0, 3, 1, 2))).sum().backward()
    assert out.shape[2:] == ((7, 7) if stride == 2 else (14, 13))
    _close(out.detach().permute(0, 2, 3, 1).numpy(), jout, what="output")
    _close(tx.grad.permute(0, 2, 3, 1).numpy(), jgx, what="input gradient")
    jgrads = state_dict_from_flax({"params": numpy_tree(jgp)})
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), jgrads[name].numpy(), what=name)
    if train:
        stats = state_dict_from_flax({"params": {}, "batch_stats": numpy_tree(jupd["batch_stats"])})
        for name, ref in stats.items():
            if "running" in name:
                got = tm.state_dict()[name].numpy()
                assert not np.allclose(got, state_dict_from_flax(v)[name].numpy()), name  # updated
                _close(got, ref.numpy(), what=name)


def test_stem_relayout_with_extra_taps():
    """EfficientNet's 3x3 SAME stem in s2d form (2x2 taps over 12 channels,
    s2d padding (0, 1)) is the port's 4x4 / stride-2 conv with padding
    (0, 2): a 3x3 kernel fills its taps [:3, :3]; a fresh or trained s2d
    kernel fills all 16, and both packages give the same output."""
    w = np.random.RandomState(12).randn(3, 3, 3, 40).astype(np.float32)
    w2 = np.asarray(StemConvS2D.transform_kernel(w, pad_lo=0))
    assert w2.shape == (2, 2, 12, 40)
    w4 = stem_kernel_from_s2d(w2)
    assert w4.shape == (4, 4, 3, 40)
    np.testing.assert_array_equal(w4[:3, :3], w)
    assert not w4[3].any() and not w4[:, 3].any()

    rng = np.random.RandomState(13)
    w2_full = rng.randn(2, 2, 12, 40).astype(np.float32) * 0.1
    assert stem_kernel_from_s2d(w2_full)[3].any()  # the 7 extra taps carry weight
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    ref = StemConvS2D(40, kernel_size=3, pad_lo=0).apply({"params": {"kernel": jnp.asarray(w2_full)}},
                                                         jnp.asarray(x))
    stem = StemConv(40, kernel_size=3, pad_lo=0)
    assert stem.weight.shape == (40, 3, 4, 4)
    with torch.no_grad():
        stem.weight.copy_(_t(stem_kernel_from_s2d(w2_full).transpose(3, 2, 0, 1)))
        out = stem(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        direct = torch.nn.functional.conv2d(torch.nn.functional.pad(_t(x).permute(0, 3, 1, 2), (0, 2, 0, 2)),
                                            stem.weight, stride=2).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (2, 16, 16, 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(direct.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def flax_effnet():
    """A flax init of EffNetEncoder (its parameters do not depend on the
    input size, so it is made at 32^2)."""
    jm = jeff.EffNetEncoder()
    return numpy_tree(jax.jit(lambda x: jm.init(jax.random.PRNGKey(5), x))(jnp.zeros((1, 32, 32, 3))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_effnet_encoder(flax_effnet, dtype):
    """The whole EffNetEncoder at 224^2, batch 2: 26 blocks, the 1536-channel
    head averaged in fp32, and the low tap of block 4 at (2, 32, 56, 56)."""
    imgs = np.random.RandomState(0).rand(2, 224, 224, 3).astype(np.float32)
    jm = jeff.EffNetEncoder(dtype=getattr(jnp, dtype))
    v = _random_stats(flax_effnet, seed=1)
    jlow, jfeat = jax.jit(lambda v, x: jm.apply(v, x))(v, jnp.asarray(imgs))
    jlow, jfeat = np.asarray(jlow.astype(jnp.float32)), np.asarray(jfeat)
    tm = teff.EffNetEncoder()
    assert tm.backbone.n_blocks == 26 and (tm.backbone.low_channels, tm.backbone.out_channels) == (32, 1536)
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    tm.eval()
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16, enabled=dtype == "bfloat16"):
        low, feat = tm(_t(imgs))
    assert low.shape == (2, 32, 56, 56) and feat.shape == (2, 1536) and feat.dtype == torch.float32
    low = low.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        _close(low, jlow, what="low")
        _close(feat.numpy(), jfeat, what="feat")
    else:
        assert rel_l2(low, jlow) < 1e-2 and rel_l2(feat.numpy(), jfeat) < 1e-2, (rel_l2(low, jlow),
                                                                                rel_l2(feat.numpy(), jfeat))


def test_light_estimator_32_channels():
    """EfficientNet-b3's light branch: conv1 at stride 4 on the 56x56x32 low
    map, so fc0 sees 256 inputs as in the ResNet branch."""
    x = np.random.RandomState(3).randn(2, 56, 56, 32).astype(np.float32)
    jm = JLightEstimator()
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    tm = LightEstimator(32)
    tm.load_state_dict(state_dict_from_flax(numpy_tree(v)), strict=True)
    with torch.no_grad():
        out = tm(_t(x).permute(0, 3, 1, 2))
    for k in ("colors", "directions"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)


def test_effb3_model_converts_and_matches():
    """The converter on the whole effb3 model (MANO, no render, light
    estimation, 224^2, fp32): every flax parameter and statistic maps to a
    port tensor one to one (strict), and the encoder, heads and light
    estimator agree."""
    from hifihr_tpu.models.hifihr import HiFiHR as JModel
    from hifihr_tpu_torch.models.hifihr import HiFiHR

    d = dict(pretrain="effb3", hand_model="mano", render=False, light_estimation=True, image_size=224,
             compute_dtype="float32")
    jm = JModel(config=JConfig(**d))
    imgs = np.random.RandomState(9).rand(1, 224, 224, 3).astype(np.float32)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, train=False))(jnp.asarray(imgs))
    v = _random_stats(v, seed=4)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(imgs))
    tm = HiFiHR(Config(**d))
    sd = state_dict_from_flax(v)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    with torch.no_grad():
        out = tm(_t(imgs))
    for k in ("pose_params", "shape_params", "scale", "trans", "rot", "joints", "mano_verts"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    for k in ("colors", "directions"):
        np.testing.assert_allclose(out["light_params"][k].numpy(), np.asarray(ref["light_params"][k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_init_distributions(flax_effnet):
    """init_weights draws every effb3 encoder conv as flax initialises it:
    the stem variance_scaling(2, fan_out) over its (2, 2, 12, 40) s2d shape,
    the other convs lecun_normal with fan_in = (C_in / groups) k^2 (k^2 for a
    depthwise conv), all truncated at 2 sigma, biases zero; the standard
    deviations are held against a flax init of the same encoder."""
    from hifihr_tpu_torch.models.hifihr import HiFiHR, init_weights

    jsd = state_dict_from_flax(flax_effnet)
    model = init_weights(HiFiHR(Config(pretrain="effb3", render=False, image_size=64)), seed=3)
    convs = {n: m for n, m in model.encoder.named_modules() if isinstance(m, torch.nn.Conv2d)}
    assert len(convs) == 2 + 26 * 4 + 24  # stem, head; depthwise, SE pair, project; 24 expands
    for name, m in convs.items():
        w, ref = m.weight.detach(), jsd[f"{name}.weight"]
        n = w.numel()
        if isinstance(m, StemConv):
            want = (2.0 / (2 * 2 * 40)) ** 0.5
        else:
            want = (1.0 / w[0].numel()) ** 0.5
        tol = 5 / (2 * n) ** 0.5
        assert abs(w.std().item() / want - 1) < tol, (name, w.std().item(), want)
        assert abs(ref.std().item() / want - 1) < tol, (name, ref.std().item(), want)
        assert w.abs().max().item() <= 2 * want / 0.87962566103423978 * (1 + 1e-6), name
        if m.bias is not None:
            assert not m.bias.any()
