"""The port's NIMBLE modules against the JAX package on the same numpy
inputs (CPU, fp32): the asset, NimbleLayer, the joint remap, the NIMBLE
HandEncoder from converted flax weights, the `mtex` and `edge_length` loss
branches, vertex normals and tangents, shading with the appearance maps,
`fragment_interpolate` with per-face-corner channels, the corner gather
through K2 and K3, and the plain K1 at NIMBLE's 11,926 faces.

Tolerances:
- NimbleLayer: every output at rtol 1e-5 (fp32 sums taken in another
  order; atol 1e-6 of each output's largest value for entries near 0);
  the corner tables bit-equal (the same float64 numpy code); the maps
  upsampled to 256^2 within 2.5e-7: F.interpolate and jax.image.resize
  compute the bilinear weights otherwise and differ by an ulp (1.2e-7 on
  the diffuse mean, which is below 1);
- normals and tangents: 2e-6 against a float64 numpy formula; 1e-5 against
  JAX's fp32 accumulation (its scatter-add fallback, which the test makes
  it take); against JAX's default bf16 incidence matmul, the bound that
  bf16 rounding gives: each summed face value carries a relative error of
  at most u = 2^-9, so a vertex's sum moves by at most u sum_i |x_i|
  (componentwise), and its unit vector by at most twice that over |sum_i x_i|;
- shading, interpolation values and gradients: 1e-5 absolute, relative to
  the largest value where the values are large (fp32 in another order);
- the plain K1: face_id and coverage exactly equal to the interpreted
  Pallas kernel run op by op, zbuf at rtol 1e-6 (the interpreted body
  contracts its depth-plane multiply-add);
- the corner gather: bit-equal to index_select; its backward within the
  fp32 reordering bound of an index_add_ (it is the plain K3 here);
- the model without its render (res18 encoder, heads, NIMBLE layer) from
  converted weights: 1e-4, as the MANO encoder's test (convolutions summed
  in another order); the corner render: coverage exactly equal, the rest
  1e-5 absolute, with JAX's corner accumulation in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.render.raster_jax import project_to_screen as jax_project
from hifihr_tpu_torch.render.renderer import morton_face_order
from torch_port_helpers import fake_K, nimble_params, posed_nimble_verts, randomize_variables

S = 32


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def layers():
    from hifihr_tpu.hand.nimble import NimbleLayer as JNimble
    from hifihr_tpu_torch.hand.nimble import NimbleLayer

    return JNimble(), NimbleLayer()


@pytest.fixture(scope="module")
def scene(layers):
    """Two posed NIMBLE hands at 32 px: camera-space verts, their screen
    projection, the faces in the renderer's Morton order, the atlas
    corners in that order, and the port's plain K1 selection."""
    from hifihr_tpu_torch.render.raster_msaa import rasterize_msaa_plain

    _, tl = layers
    order = morton_face_order(tl.v_template_np, tl.faces_np)
    faces, face_uv = tl.faces_np[order], tl.face_uv_np[order]
    verts = posed_nimble_verts(2, seed=3)
    vs = np.asarray(jax_project(jnp.asarray(verts), jnp.asarray(fake_K(2, S))))
    fid, cov, _ = rasterize_msaa_plain(_t(vs), torch.tensor(faces).long(), S)
    return verts, vs, faces, face_uv, fid.numpy(), cov.numpy()


def test_nimble_asset_equals_jax():
    from hifihr_tpu.hand.nimble import _ASSET
    from hifihr_tpu_torch.assets import DEFAULT_NIMBLE_NPZ

    with np.load(_ASSET) as a, np.load(DEFAULT_NIMBLE_NPZ) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("with_rot", [False, True])
def test_nimble_layer_matches_jax(layers, with_rot):
    jl, tl = layers
    p = nimble_params(3, seed=1)
    if with_rot:
        p["rot"] = (np.random.RandomState(2).randn(3, 3) * 0.8).astype(np.float32)
    ref = jl({k: jnp.asarray(v) for k, v in p.items()})
    out = tl({k: _t(v) for k, v in p.items()})
    assert set(out) == set(ref)
    shapes = {"nimble_joints": (3, 25, 3), "verts": (3, 5990, 3), "skin_verts": (3, 5990, 3),
              "skin_albedo": (3, 5990, 3), "mano_verts": (3, 778, 3), "textures": (3, 256, 256, 7),
              "joints": (3, 21, 3), "rot": (3, 3)}
    for k, r in ref.items():
        r = np.asarray(r)
        assert tuple(out[k].shape) == r.shape == shapes[k], k
        np.testing.assert_allclose(out[k].numpy(), r, rtol=1e-5, atol=1e-6 * np.abs(r).max(), err_msg=k)


def test_nimble_layer_init_constants(layers):
    jl, tl = layers
    np.testing.assert_array_equal(tl.corner_mean_np, jl.corner_mean_np)
    np.testing.assert_array_equal(tl.corner_basis_np, jl.corner_basis_np)
    assert tl.corner_mean_np.shape == (11926, 3, 7) and tl.corner_basis_np.shape == (11926, 3, 7, 10)
    for name in ("tex_mean_uv", "tex_basis_uv"):
        r = np.asarray(getattr(jl, name))
        assert tuple(getattr(tl, name).shape) == r.shape
        np.testing.assert_allclose(getattr(tl, name).numpy(), r, rtol=0, atol=2.5e-7, err_msg=name)
    np.testing.assert_array_equal(tl.faces_np, jl.faces_np)
    np.testing.assert_array_equal(tl.face_uv_np, jl.face_uv_np)


def test_mano_to_frei_remap():
    from hifihr_tpu.geometry.joints import MANO_TO_FREI as JPERM, remap as jremap
    from hifihr_tpu_torch.geometry.joints import MANO_TO_FREI, remap

    np.testing.assert_array_equal(MANO_TO_FREI, JPERM)
    assert sorted(MANO_TO_FREI.tolist()) == list(range(21))
    j = np.random.RandomState(0).randn(2, 21, 3).astype(np.float32)
    np.testing.assert_array_equal(remap(_t(j), MANO_TO_FREI).numpy(), np.asarray(jremap(jnp.asarray(j), JPERM)))


@pytest.mark.parametrize("render", [True, False])
def test_nimble_hand_encoder_from_converted_weights(render):
    """The NIMBLE HandEncoder (a tex head when rendering, zeros when not; no
    rot head) and the NIMBLE layer through the whole model, without the
    render (no Ks), from flax weights converted one to one."""
    from hifihr_tpu.config import Config as JConfig
    from hifihr_tpu.models.hifihr import HiFiHR as JModel
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.convert import state_dict_from_flax
    from hifihr_tpu_torch.models.hifihr import HiFiHR

    d = dict(pretrain="res18", hand_model="nimble", render=render, light_estimation=False, image_size=S,
             compute_dtype="float32")
    jm = JModel(config=JConfig(**d))
    imgs = np.random.RandomState(4).rand(2, S, S, 3).astype(np.float32)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(2), x, train=False))(jnp.asarray(imgs))
    v = randomize_variables(v, seed=4)
    heads = set(v["params"]["hand_encoder"])
    assert ("tex_out" in heads) == render and "rot_out" not in heads and "vert_tex" not in v["params"]
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(imgs))
    tm = HiFiHR(Config(**d))
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    tm.eval()
    with torch.no_grad():
        out = tm(_t(imgs))
    assert ref["rot"] is not None and not np.asarray(ref["rot"]).any()  # the layer's zero root rotation
    for k in ("pose_params", "shape_params", "texture_params", "scale", "trans", "rot", "joints",
              "mano_verts", "nimble_joints", "skin_verts", "skin_albedo"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), r, rtol=1e-4, atol=1e-4 * max(np.abs(r).max(), 1e-3),
                                   err_msg=k)
    if not render:
        assert not out["texture_params"].any()
    np.testing.assert_array_equal(out["mano_faces"].numpy(), np.asarray(ref["mano_faces"]))


def test_mtex_and_edge_length_losses():
    from hifihr_tpu.config import Config as JConfig
    from hifihr_tpu.losses.stack import LossComputer as JLoss
    from hifihr_tpu_torch.assets import load_mano_model
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.losses.stack import LossComputer

    rng = np.random.RandomState(5)
    faces = load_mano_model().faces
    outputs = {"mano_verts": rng.randn(2, 778, 3).astype(np.float32) * 0.05,
               "texture_params": rng.randn(2, 10).astype(np.float32), "mano_faces": faces,
               "joints": rng.randn(2, 21, 3).astype(np.float32)}
    examples = {"verts": rng.randn(2, 778, 3).astype(np.float32) * 0.05}
    d = dict(losses=("mtex", "edge_length"), lambda_edge_len=0.3, lambda_tex_reg_list=(2e-3,))
    ref = JLoss(JConfig(**d))({k: jnp.asarray(v) for k, v in examples.items()},
                              {k: jnp.asarray(v) for k, v in outputs.items()}, "FreiHand")
    out = LossComputer(Config(**d))({k: _t(v) for k, v in examples.items()},
                                    {k: _t(v) for k, v in outputs.items()}, "FreiHand")
    assert list(out) == list(ref) == ["edge_length", "mtex", "total"]
    for k in out:
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-5, err_msg=k)
    # no texture head (MANO): mtex does not fire
    del outputs["texture_params"]
    out = LossComputer(Config(**d))({k: _t(v) for k, v in examples.items()},
                                    {k: _t(v) for k, v in outputs.items()}, "FreiHand")
    assert list(out) == ["edge_length", "total"]


def _normals_tangents_f64(verts, faces, face_uv):
    """The float64 formula: area-weighted face normals and UV tangents summed
    onto the corners, normalised."""
    tri = verts[:, faces].astype(np.float64)  # (B, F, 3, 3)
    uv = face_uv.astype(np.float64)
    e1, e2 = tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0]
    fn = np.cross(e1, e2)
    d1, d2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    ft = (e1 * d2[None, :, 1, None] - e2 * d1[None, :, 1, None]) / det[None, :, None]
    acc = np.zeros((verts.shape[0], verts.shape[1], 6))
    abs_acc = np.zeros_like(acc)
    for k in range(3):
        np.add.at(acc, (slice(None), faces[:, k]), np.concatenate([fn, ft], -1))
        np.add.at(abs_acc, (slice(None), faces[:, k]), np.abs(np.concatenate([fn, ft], -1)))

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return unit(acc[..., :3]), unit(acc[..., 3:]), acc, abs_acc


def test_vertex_normals_and_tangents(scene, monkeypatch):
    import hifihr_tpu.render.mesh as jmesh
    from hifihr_tpu_torch.render.mesh import vertex_normals, vertex_normals_and_tangents, vertex_tangents

    verts, _, faces, face_uv, _, _ = scene
    vn, vt = vertex_normals_and_tangents(_t(verts), torch.tensor(faces).long(), _t(face_uv))
    vn, vt = vn.numpy(), vt.numpy()
    rn, rt, acc, abs_acc = _normals_tangents_f64(verts, faces, face_uv)
    used = np.zeros(verts.shape[1], bool)
    used[faces.reshape(-1)] = True
    assert used.all()
    np.testing.assert_allclose(vn, rn, atol=2e-6)
    np.testing.assert_allclose(vt, rt, atol=2e-6)
    np.testing.assert_array_equal(vertex_normals(_t(verts), torch.tensor(faces).long()).numpy(), vn)
    np.testing.assert_array_equal(vertex_tangents(_t(verts), torch.tensor(faces).long(), _t(face_uv)).numpy(), vt)

    args = (jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(face_uv))
    # JAX's default: a bf16 incidence matmul for a mesh this size
    jn, jt = (np.asarray(x) for x in jmesh.vertex_normals_and_tangents(*args))
    u = 2.0**-9  # bf16's unit roundoff
    for got, ref, lo in ((jn, rn, slice(0, 3)), (jt, rt, slice(3, 6))):
        bound = 2 * u * np.linalg.norm(abs_acc[..., lo], axis=-1) / np.linalg.norm(acc[..., lo], axis=-1)
        err = np.linalg.norm(got - ref, axis=-1)
        assert np.all(err <= bound + 1e-6), (err - bound).max()
        assert err.max() > 1e-4  # it does take the bf16 path
        port = vn if lo.start == 0 else vt
        assert np.all(np.linalg.norm(port - got, axis=-1) <= bound + 3e-6)

    # JAX's fp32 fallback (a serial scatter-add), taken when the incidence
    # matrix cannot be built
    def no_incidence(*_):
        raise RuntimeError("the test takes the fp32 corner accumulation")

    monkeypatch.setattr(jmesh, "_corner_incidence", no_incidence)
    jn, jt = (np.asarray(x) for x in jmesh.vertex_normals_and_tangents(*args))
    np.testing.assert_allclose(vn, jn, atol=1e-5)
    np.testing.assert_allclose(vt, jt, atol=1e-5)


def test_phong_shade_with_maps():
    from hifihr_tpu.render.shading import DirectionalLight as JLight, phong_shade as jfn
    from hifihr_tpu_torch.render.shading import DirectionalLight, phong_shade

    rng = np.random.RandomState(6)
    shp = (2, 16, 16)
    texels, normal_map = rng.rand(*shp, 3).astype(np.float32), rng.rand(*shp, 3).astype(np.float32)
    normals, tangents = rng.randn(*shp, 3).astype(np.float32), rng.randn(*shp, 3).astype(np.float32)
    normals[0, 0, 0] = tangents[0, 0, 0] = 0.0  # background pixels interpolate to zero
    spec_map = rng.rand(*shp, 1).astype(np.float32)
    points = (rng.randn(*shp, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)
    colors, dirs = rng.uniform(-1, 1, (2, 3)).astype(np.float32), rng.randn(2, 3).astype(np.float32)
    ref = jfn(jnp.asarray(texels), jnp.asarray(normals), jnp.asarray(points),
              JLight.from_estimator(jnp.asarray(colors), jnp.asarray(dirs)), normal_map=jnp.asarray(normal_map),
              tangents=jnp.asarray(tangents), spec_map=jnp.asarray(spec_map))
    out = phong_shade(_t(texels), _t(normals), _t(points), DirectionalLight.from_estimator(_t(colors), _t(dirs)),
                      normal_map=_t(normal_map), tangents=_t(tangents), spec_map=_t(spec_map))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    plain = phong_shade(_t(texels), _t(normals), _t(points), DirectionalLight.from_estimator(_t(colors), _t(dirs)))
    assert np.abs(plain.numpy() - out.numpy()).max() > 0.05  # the maps matter


def test_fragment_interpolate_corner_attrs(scene):
    """Values and gradients (to the screen corners, the vertex attributes
    and the per-corner channels) of the 48-float row's interpolation."""
    from hifihr_tpu.render.interpolate import fragment_interpolate as jfn
    from hifihr_tpu_torch.render.interpolate import fragment_interpolate

    _, vs, faces, _, fid, _ = scene
    rng = np.random.RandomState(7)
    B, F = fid.shape[0], faces.shape[0]
    attrs = rng.randn(B, vs.shape[1], 6).astype(np.float32)
    corner = rng.rand(B, F, 3, 7).astype(np.float32)
    covered = fid >= 0
    assert 0.05 < covered.mean() < 0.95
    g_pix = rng.randn(B, S, S, 13).astype(np.float32)
    g_z = rng.randn(B, S, S).astype(np.float32)

    def jloss(vs, attrs, corner):
        pix, mask, zbuf = jfn(jnp.asarray(fid), vs, jnp.asarray(faces), attrs, corner_attrs_batched=corner)
        return jnp.sum(pix * g_pix) + jnp.sum(jnp.where(covered, zbuf, 0.0) * g_z), (pix, mask, zbuf)

    (_, (pj, mj, zj)), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(vs), jnp.asarray(attrs), jnp.asarray(corner))
    leaves = [_t(x).requires_grad_() for x in (vs, attrs, corner)]
    pt, mt, zt = fragment_interpolate(_t(fid), leaves[0], torch.tensor(faces).long(), leaves[1],
                                      corner_attrs_batched=leaves[2])
    assert pt.shape == (B, S, S, 13)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(zt.detach().numpy()[covered], np.asarray(zj)[covered], rtol=1e-6)
    ((pt * _t(g_pix)).sum() + (torch.where(_t(covered), zt, torch.zeros_like(zt)) * _t(g_z)).sum()).backward()
    for name, leaf, ref in zip(("verts_screen", "vert_attrs", "corner_attrs"), leaves, grads_j):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=1e-5 * np.abs(ref).max(), err_msg=name)


def test_k1_plain_at_nimble_face_count(scene):
    """The plain K1 on two posed NIMBLE hands (11,926 faces, 32 px) against
    the interpreted Pallas kernel, op by op."""
    from hifihr_tpu.render.raster_msaa import rasterize_msaa_pallas

    _, vs, faces, _, fid, cov = scene
    assert faces.shape == (11926, 3)
    from hifihr_tpu_torch.render.raster_msaa import rasterize_msaa_plain

    _, _, zp = rasterize_msaa_plain(_t(vs), torch.tensor(faces).long(), S)
    with jax.disable_jit():
        fj, cj, zj = (np.asarray(x) for x in rasterize_msaa_pallas(jnp.asarray(vs), jnp.asarray(faces), S,
                                                                   samples=3, interpret=True))
    np.testing.assert_array_equal(fid, fj)
    np.testing.assert_array_equal(cov, cj)
    covered = fj >= 0
    assert 0.05 < covered.mean() < 0.95 and len(np.unique(fj[covered])) > 200
    np.testing.assert_allclose(zp.numpy()[covered], zj[covered], rtol=1e-6)
    assert np.all(np.isinf(zp.numpy()[~covered]))


def test_corner_gather_through_k2_and_k3(scene, monkeypatch):
    """A NIMBLE-sized mesh gathers its face corners with gather_rows
    (3 F V = 214 M): the plain K2 equals index_select, and the backward (the
    plain K3) equals index_add_ within fp32 reordering."""
    from hifihr_tpu_torch.render import gather, mesh
    from hifihr_tpu_torch.render.mesh import ONEHOT_LIMIT, gather_face_rows

    calls = []

    def counted(table, idx):
        calls.append(tuple(idx.shape))
        return gather.gather_rows(table, idx)

    monkeypatch.setattr(mesh, "gather_rows", counted)

    verts, _, faces, _, _, _ = scene
    B, V = verts.shape[:2]
    F = faces.shape[0]
    assert 3 * F * V > ONEHOT_LIMIT
    x = torch.tensor(np.random.RandomState(8).randn(B, V, 9).astype(np.float32), requires_grad=True)
    tf = torch.tensor(faces).long()
    got = gather_face_rows(x, tf)
    assert calls == [(B, 3 * F)]
    ref = x.index_select(1, tf.reshape(-1)).reshape(B, F, 27)
    assert torch.equal(got, ref)
    g = torch.randn(B, F, 27, generator=torch.Generator().manual_seed(0))
    (dx,) = torch.autograd.grad(got, x, g)
    (dref,) = torch.autograd.grad(ref, x, g)
    rows = np.bincount(faces.reshape(-1), minlength=V)[None, :, None]
    abs_sum = torch.zeros(B, V, 9).index_add_(1, tf.reshape(-1), g.abs().reshape(B, 3 * F, 9)).numpy()
    assert np.all(np.abs(dx.numpy() - dref.numpy()) <= 2 * (rows - 1) * 2.0**-24 * abs_sum)
    small = x[:, :778]  # MANO's size keeps index_select
    from hifihr_tpu_torch.assets import load_mano_model

    gather_face_rows(small, torch.tensor(load_mano_model().faces).long())
    assert len(calls) == 1


def test_renderer_corner_path_matches_jax(scene, layers, monkeypatch):
    """The MSAA corner render of two NIMBLE hands: JAX's op by op with the
    kernel's face rule and its fp32 corner accumulation, against the
    port's."""
    import hifihr_tpu.render.mesh as jmesh
    from hifihr_tpu.render import raster_jax
    from hifihr_tpu.render.raster_msaa import rasterize_msaa_pallas
    from hifihr_tpu.render.renderer import PhongRenderer as JRenderer, RenderSettings as JSettings
    from hifihr_tpu.render.shading import DirectionalLight as JLight
    from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings
    from hifihr_tpu_torch.render.shading import DirectionalLight

    def select(self, verts_cam, K_base):
        vs = raster_jax.project_to_screen(jax.lax.stop_gradient(verts_cam), K_base)
        fid, cov, _ = rasterize_msaa_pallas(vs, self.faces, self.settings.image_size,
                                            samples=self.settings.aa_factor, interpret=True)
        return fid, cov

    def no_incidence(*_):
        raise RuntimeError("the test takes the fp32 corner accumulation")

    monkeypatch.setattr(JRenderer, "_select_faces_msaa", select)
    monkeypatch.setattr(jmesh, "_corner_incidence", no_incidence)
    jl, tl = layers
    verts = scene[0]
    rng = np.random.RandomState(9)
    albedo = rng.rand(2, 5990, 3).astype(np.float32)
    tex = (rng.randn(2, 10) * 0.5).astype(np.float32)
    colors, dirs = rng.uniform(0, 1, (2, 3)).astype(np.float32), rng.randn(2, 3).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.5  # light from the camera's side
    K = fake_K(2, S)
    jr = JRenderer(jl.faces_np, JSettings(S, 3, aa_mode="msaa", with_depth=True), vert_uv=jl.vert_uv,
                   face_uv=jl.face_uv_np, sort_template=jl.v_template_np, corner_mean=jl.corner_mean_np,
                   corner_basis=jl.corner_basis_np)
    tr = PhongRenderer(tl.faces_np, tl.v_template_np, RenderSettings(S, 3), face_uv=tl.face_uv_np,
                       corner_mean=tl.corner_mean_np, corner_basis=tl.corner_basis_np)
    with jax.disable_jit():
        ref = np.asarray(jr(jnp.asarray(verts), jnp.asarray(albedo), jnp.asarray(K),
                            JLight.from_estimator(jnp.asarray(colors), jnp.asarray(dirs)), tex_coef=jnp.asarray(tex)))
    out = tr(_t(verts), _t(albedo), _t(K), DirectionalLight.from_estimator(_t(colors), _t(dirs)),
             tex_coef=_t(tex)).numpy()
    assert out.shape == ref.shape == (2, S, S, 5)
    np.testing.assert_array_equal(out[..., 3], ref[..., 3])
    assert (ref[..., 3] > 0).mean() > 0.05 and ref[..., :3].max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-5)
