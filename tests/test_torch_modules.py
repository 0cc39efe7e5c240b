"""The port's modules against their JAX counterparts on the same numpy
inputs (CPU, fp32).

Tolerances: geometry, MANO and shading 1e-5 absolute (fp32 sums taken in
another order); `accumulate_corners` 1e-6 relative to the largest value (an
fp32 index_add_ against an exact-precision einsum); the ResNet-50 encoder and
heads 1e-4 (fifty conv layers of fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu_torch.config import Config
from torch_port_helpers import fake_K, posed_mano_verts, randomize_variables


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def mano_pair():
    from hifihr_tpu.hand.mano import ManoLayer as JMano
    from hifihr_tpu_torch.hand.mano import ManoLayer

    return JMano(ncomps=45), ManoLayer(ncomps=45)


def test_config_from_one_dict():
    d = dict(pretrain="res18", hand_model="mano", use_mean_shape=True, render=True,
             light_estimation=False, image_size=32, aa_factor=3, aa_mode="msaa",
             compute_dtype="float32", rgb2hm=False)
    jc, tc = JConfig(**d), Config(**d)
    for k in d:
        assert getattr(jc, k) == getattr(tc, k)
    assert jc.ncomps == tc.ncomps
    defaults = Config()
    for k in d:
        assert getattr(defaults, k) == getattr(JConfig(), k)
    # the model variants the port runs since mano_new and NIMBLE's UV and
    # SSAA paths came, since the rgb2hm branch and the fsdp mesh came, and
    # since HRNet and the four-channel input came
    for good in (dict(hand_model="mano_new"), dict(hand_model="nimble", aa_mode="ssaa"),
                 dict(hand_model="nimble", nimble_corner_tex=False), dict(test_refinement=True),
                 dict(fsdp=2), dict(rgb2hm=True), dict(freeze_hm_estimator=True),
                 dict(pretrain="hr18sv2"), dict(four_channel=True)):
        assert Config(**good).to_dict() == JConfig(**good).to_dict()
    with pytest.raises(NotImplementedError):
        Config(aa_mode="fxaa")


def test_axis_angle_to_matrix():
    from hifihr_tpu.geometry.rotations import axis_angle_to_matrix as jfn
    from hifihr_tpu_torch.geometry.rotations import axis_angle_to_matrix

    aa = (np.random.RandomState(0).randn(5, 16, 3) * 1.5).astype(np.float32)
    aa[0, 0] = 0.0  # theta = 0: the 1e-8 regulariser
    np.testing.assert_allclose(axis_angle_to_matrix(_t(aa)).numpy(), np.asarray(jfn(aa)),
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_mano_layer(mano_pair, seed):
    jm, tm = mano_pair
    rng = np.random.RandomState(seed)
    pose = (rng.randn(3, 48) * 0.8).astype(np.float32)
    beta = (rng.randn(3, 10) * 1.0).astype(np.float32)
    jo = jm(jnp.asarray(pose), jnp.asarray(beta))
    to = tm(_t(pose), _t(beta))
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_regress_joints_frei(mano_pair):
    from hifihr_tpu.hand.mano import regress_joints_frei as jfn
    from hifihr_tpu_torch.hand.mano import regress_joints_frei

    jm, tm = mano_pair
    verts = posed_mano_verts(2, seed=3)
    np.testing.assert_allclose(regress_joints_frei(_t(verts), tm.J_regressor).numpy(),
                               np.asarray(jfn(jnp.asarray(verts), jm.J_regressor)), atol=1e-5)


def test_projections():
    from hifihr_tpu.geometry.projection import perspective_project as jpp
    from hifihr_tpu.render.raster_jax import project_to_screen as jps
    from hifihr_tpu_torch.geometry.projection import perspective_project
    from hifihr_tpu_torch.render.raster import project_to_screen

    verts = posed_mano_verts(2, seed=4)
    verts[0, 0, 2] = 0.0  # the 1e-8 z guard
    K = fake_K(2, 224)
    np.testing.assert_array_equal(project_to_screen(_t(verts), _t(K)).numpy(),
                                  np.asarray(jps(jnp.asarray(verts), jnp.asarray(K))))
    np.testing.assert_allclose(perspective_project(_t(verts[:, 1:]), _t(K)).numpy(),
                               np.asarray(jpp(jnp.asarray(verts[:, 1:]), jnp.asarray(K))),
                               rtol=1e-6, atol=1e-5)


def test_mesh_helpers(mano_pair):
    from hifihr_tpu.render import mesh as jmesh
    from hifihr_tpu_torch.render import mesh as tmesh

    jm, tm = mano_pair
    verts = posed_mano_verts(2, seed=5)
    faces = jm.faces_np
    tf = torch.tensor(faces).long()
    np.testing.assert_array_equal(
        tmesh.gather_face_rows(_t(verts), tf).numpy(),
        np.asarray(jmesh.gather_face_rows(jnp.asarray(verts), jnp.asarray(faces))))
    fn_t = tmesh.face_normals(_t(verts), tf)
    np.testing.assert_allclose(fn_t.numpy(),
                               np.asarray(jmesh.face_normals(jnp.asarray(verts), jnp.asarray(faces))),
                               atol=1e-9)
    acc_t = tmesh.accumulate_corners(fn_t, tf, 778).numpy()
    acc_j = np.asarray(jmesh.accumulate_corners(jnp.asarray(fn_t.numpy()), jnp.asarray(faces), 778))
    np.testing.assert_allclose(acc_t, acc_j, atol=1e-6 * np.abs(acc_j).max())
    np.testing.assert_allclose(tmesh.vertex_normals(_t(verts), tf).numpy(),
                               np.asarray(jmesh.vertex_normals(jnp.asarray(verts), jnp.asarray(faces))),
                               atol=1e-5)


def test_morton_face_order(mano_pair):
    from hifihr_tpu.render.renderer import morton_face_order as jfn
    from hifihr_tpu_torch.render.renderer import morton_face_order

    jm, _ = mano_pair
    np.testing.assert_array_equal(morton_face_order(jm.v_template_np, jm.faces_np),
                                  jfn(jm.v_template_np, jm.faces_np))


def _shading_inputs(S=32, seed=6):
    from hifihr_tpu_torch.render.raster import project_to_screen
    from hifihr_tpu_torch.render.raster_msaa import rasterize_msaa_plain
    from hifihr_tpu_torch.render.renderer import morton_face_order
    from hifihr_tpu_torch.assets import load_mano_model

    m = load_mano_model()
    faces = np.asarray(m.faces, np.int64)[morton_face_order(m.v_template, m.faces)]
    verts = posed_mano_verts(2, seed)
    K = fake_K(2, S)
    vs = project_to_screen(_t(verts), _t(K))
    fid, cov, _ = rasterize_msaa_plain(vs, torch.tensor(faces), S)
    rng = np.random.RandomState(seed)
    attrs = rng.rand(2, 778, 6).astype(np.float32)
    return fid.numpy(), cov.numpy(), vs.numpy(), faces, attrs, verts, K


def test_fragment_interpolate():
    from hifihr_tpu.render.interpolate import fragment_interpolate as jfn
    from hifihr_tpu_torch.render.interpolate import fragment_interpolate

    fid, _, vs, faces, attrs, _, _ = _shading_inputs()
    assert (fid >= 0).mean() > 0.05
    pj, mj, zj = jfn(jnp.asarray(fid), jnp.asarray(vs), jnp.asarray(faces), jnp.asarray(attrs))
    pt, mt, zt = fragment_interpolate(_t(fid), _t(vs), torch.tensor(faces), _t(attrs))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    covered = fid >= 0
    np.testing.assert_allclose(zt.numpy()[covered], np.asarray(zj)[covered], atol=1e-5)
    assert np.all(np.isinf(zt.numpy()[~covered]))


def test_phong_shade():
    from hifihr_tpu.render.shading import DirectionalLight as JLight, phong_shade as jfn
    from hifihr_tpu_torch.render.shading import DirectionalLight, phong_shade

    rng = np.random.RandomState(7)
    texels = rng.rand(2, 16, 16, 3).astype(np.float32)
    normals = rng.randn(2, 16, 16, 3).astype(np.float32)
    normals[0, 0, 0] = 0.0  # uncovered pixels interpolate to zero normals
    points = (rng.randn(2, 16, 16, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)
    colors = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    dirs = rng.randn(2, 3).astype(np.float32)
    ref = jfn(jnp.asarray(texels), jnp.asarray(normals), jnp.asarray(points),
              JLight.from_estimator(jnp.asarray(colors), jnp.asarray(dirs)))
    out = phong_shade(_t(texels), _t(normals), _t(points),
                      DirectionalLight.from_estimator(_t(colors), _t(dirs)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    ref = jfn(jnp.asarray(texels), jnp.asarray(normals), jnp.asarray(points), JLight.default(2))
    out = phong_shade(_t(texels), _t(normals), _t(points), DirectionalLight.default(2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_renderer_msaa_matches_jax(monkeypatch):
    """The whole MSAA renderer, with JAX selecting faces by the kernel's rule
    (its CPU path otherwise emulates MSAA from an SSAA raster)."""
    from hifihr_tpu.render import raster_jax
    from hifihr_tpu.render.raster_msaa import rasterize_msaa_pallas
    from hifihr_tpu.render.renderer import PhongRenderer as JRenderer, RenderSettings as JSettings
    from hifihr_tpu_torch.assets import load_mano_model
    from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings

    def select(self, verts_cam, K_base):
        vs = raster_jax.project_to_screen(jax.lax.stop_gradient(verts_cam), K_base)
        fid, cov, _ = rasterize_msaa_pallas(vs, self.faces, self.settings.image_size,
                                            samples=self.settings.aa_factor, interpret=True)
        return fid, cov

    monkeypatch.setattr(JRenderer, "_select_faces_msaa", select)
    m = load_mano_model()
    S = 32
    verts = posed_mano_verts(2, seed=8)
    colors = np.random.RandomState(8).rand(2, 778, 3).astype(np.float32)
    K = fake_K(2, S)
    jr = JRenderer(m.faces, JSettings(S, 3, aa_mode="msaa", with_depth=True),
                   sort_template=m.v_template)
    tr = PhongRenderer(m.faces, m.v_template, RenderSettings(S, 3))
    with jax.disable_jit():
        ref = np.asarray(jr(jnp.asarray(verts), jnp.asarray(colors), jnp.asarray(K)))
    out = tr(_t(verts), _t(colors), _t(K)).numpy()
    assert out.shape == ref.shape == (2, S, S, 5)
    np.testing.assert_array_equal(out[..., 3], ref[..., 3])
    np.testing.assert_allclose(out, ref, atol=1e-5)


def _encoder_and_heads_match_jax(pretrain, light_estimation, image_size, seed):
    """The encoder `pretrain` with its heads (and light estimator), fp32,
    B=1, from converted JAX weights: low, feat and the hand outputs within
    1e-4 of the JAX package."""
    from hifihr_tpu.models.hifihr import HiFiHR as JModel
    from hifihr_tpu.networks.resnet import ResNetEncoder as JEncoder
    from hifihr_tpu_torch.convert import state_dict_from_flax
    from hifihr_tpu_torch.models.hifihr import HiFiHR

    d = dict(pretrain=pretrain, hand_model="mano", render=False, light_estimation=light_estimation,
             image_size=image_size, compute_dtype="float32")
    jm = JModel(config=JConfig(**d))
    imgs = np.random.RandomState(seed).rand(1, image_size, image_size, 3).astype(np.float32)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, train=False))(jnp.asarray(imgs))
    v = randomize_variables(v, seed=seed)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(imgs))
    jlow, jfeat = JEncoder(variant=pretrain).apply(
        {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]},
        jnp.asarray(imgs), train=False)

    tm = HiFiHR(Config(**d))
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    tm.eval()
    with torch.no_grad():
        low, feat = tm.encoder(_t(imgs))
        out = tm(_t(imgs))
    assert low.shape == (1, 512, image_size // 8, image_size // 8) and feat.shape == (1, 2048)
    np.testing.assert_allclose(low.permute(0, 2, 3, 1).numpy(), np.asarray(jlow), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=1e-4, atol=1e-4)
    for k in ("pose_params", "shape_params", "scale", "trans", "rot", "joints", "mano_verts"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-4)
    if light_estimation:
        for k in ("colors", "directions"):
            np.testing.assert_allclose(out["light_params"][k].numpy(),
                                       np.asarray(ref["light_params"][k]), rtol=1e-4, atol=1e-4)
    else:
        assert "light_params" not in out


def test_resnet50_encoder_heads_and_light_estimator():
    """The flagship encoder (res50, 224^2) with its heads and light
    estimator, fp32, B=1, from converted weights."""
    _encoder_and_heads_match_jax("res50", True, 224, seed=9)


def test_resnet101_encoder_and_heads():
    """The textured FreiHAND configuration's encoder, res101 (Bottleneck
    blocks 3, 4, 23, 3; layer3_0 to layer3_22 converted by name, loaded
    strictly), with its heads and no light estimator, as that configuration
    runs; at 64^2, which the encoder takes without the estimator."""
    _encoder_and_heads_match_jax("res101", False, 64, seed=19)


def test_stem_conversion_inverts_the_s2d_layout():
    """A 7x7 kernel put into s2d form comes back as the 8x8 kernel's taps
    [1:, 1:]; an s2d kernel with weight on every tap (a fresh flax init, or
    a trained one) gives the same stem output in both packages."""
    from hifihr_tpu.networks.resnet import StemConvS2D
    from hifihr_tpu_torch.convert import stem_kernel_from_s2d
    from hifihr_tpu_torch.networks.resnet import StemConv

    w = np.random.RandomState(10).randn(7, 7, 3, 64).astype(np.float32)
    w2 = np.asarray(StemConvS2D.transform_kernel(w))
    assert w2.shape == (4, 4, 12, 64)
    w8 = stem_kernel_from_s2d(w2)
    assert w8.shape == (8, 8, 3, 64)
    np.testing.assert_array_equal(w8[1:, 1:], w)
    assert not w8[0].any() and not w8[:, 0].any()

    rng = np.random.RandomState(11)
    w2_full = rng.randn(4, 4, 12, 64).astype(np.float32) * 0.1
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    ref = StemConvS2D(64).apply({"params": {"kernel": jnp.asarray(w2_full)}}, jnp.asarray(x))
    stem = StemConv()
    with torch.no_grad():
        stem.weight.copy_(_t(stem_kernel_from_s2d(w2_full).transpose(3, 2, 0, 1)))
        out = stem(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_normalize_batch_and_cuda_default():
    from hifihr_tpu_torch import resolve_device
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import normalize_batch

    imgs = torch.tensor([[[[0, 255, 51]]]], dtype=torch.uint8)
    out = normalize_batch({"imgs": imgs, "segms_gt": imgs[..., 0]})
    np.testing.assert_allclose(out["imgs"].numpy(), [[[[0.0, 1.0, 0.2]]]], rtol=1e-6)
    assert out["segms_gt"].dtype == torch.float32
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            build_model(Config(pretrain="res18", light_estimation=False, image_size=32))


@pytest.mark.parametrize("pretrain", ["res18", "res50", "res101"])
def test_init_distributions_resnet(pretrain):
    """init_weights draws every conv of the ResNet models as flax does: the
    s2d stem variance_scaling(2, fan_out) over its (4, 4, 12, 64) shape, the
    other convs (the encoder's, the light estimator's) lecun_normal with
    fan_in = C_in k^2, all truncated at 2 sigma, biases zero. Each conv's
    std is held against the wanted one and against a flax model.init of the
    same config (224^2, light estimation on, no render) within 5% or 5
    sigma of the std's estimate, 5 / sqrt(2n), whichever is tighter."""
    from hifihr_tpu.models.hifihr import HiFiHR as JModel
    from hifihr_tpu_torch.convert import state_dict_from_flax
    from hifihr_tpu_torch.models.hifihr import HiFiHR, init_weights
    from hifihr_tpu_torch.networks.resnet import StemConv
    from torch_port_helpers import numpy_tree

    d = dict(pretrain=pretrain, hand_model="mano", render=False, light_estimation=True, image_size=224)
    jm = JModel(config=JConfig(**d))
    v = jm.init(jax.random.PRNGKey(7), jnp.zeros((1, 224, 224, 3)), train=False)
    jsd = state_dict_from_flax(numpy_tree(v))
    model = init_weights(HiFiHR(Config(**d)), seed=3)
    convs = {n: m for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)}
    assert len(convs) == {"res18": 20, "res50": 53, "res101": 104}[pretrain] + 3  # the light estimator's three
    for name, m in convs.items():
        w, ref = m.weight.detach(), jsd[f"{name}.weight"]
        if isinstance(m, StemConv):
            want = (2.0 / (4 * 4 * 64)) ** 0.5
        else:
            want = (1.0 / w[0].numel()) ** 0.5
        tol = min(0.05, 5 / (2 * w.numel()) ** 0.5)
        for x in (w, ref):
            assert abs(x.std().item() / want - 1) < tol, (name, x.std().item(), want)
            assert x.abs().max().item() <= 2 * want / 0.87962566103423978 * (1 + 1e-6), name
        if m.bias is not None:
            assert not m.bias.any()
