"""NIMBLE's per-fragment UV path in the port (`nimble_corner_tex=False`,
MSAA) against the JAX package on the same numpy inputs (CPU, fp32):
`sample_texture` and `cylindrical_uv`, the static per-face-corner channel
of `fragment_interpolate`, the UV renderer with a per-vertex chart in both
modes, and the eval step and two train steps of the slice.

Tolerances:
- sample_texture: values 1e-6 absolute (the same fp32 operations; a clamped
  or floored coordinate is exact in both); gradients to the texture and to
  the UV 1e-5 of each one's largest entry (the texture's sums of up to four
  weights per texel, in another order);
- torch's grid_sample (bilinear, border padding, align_corners=True, on
  the grid 2 uv - 1) is the same function: it maps the grid back to
  (g + 1) / 2 (W - 1), one or two roundings off u (W - 1), and is held
  within 1e-5 of sample_texture on textures in [0, 1] (measured 2.1e-7);
- cylindrical_uv 1e-6; the static channel's interpolation values 1e-5
  absolute and its gradients 1e-5 of each one's largest entry, as the
  corner channel's (tests/test_torch_nimble.py);
- the UV renders (MANO's mesh, a cylindrical chart, a 7-channel texture,
  both modes, each package shading the same face choice) 1e-5 absolute,
  their gradients 1e-4 relative L2;
- the slice, held as tests/test_torch_nimble_slice.py holds the corner
  path: res18, 32 px, batch 8, JAX's face choice (the Pallas kernel
  interpreted op by op) shaded by both, the port's own choice at 99.5% of
  pixels or more; eval geometry and parameters 1e-4, the render 1e-4
  absolute; step 1's terms 1e-4 relative and its gradients 1e-3 relative
  L2; step 2's total 1e-4 and its terms 1e-2 (the run is chaotic from the
  second step, Adam's first update being about lr sign(g)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from hifihr_tpu.render.texture import cylindrical_uv as jcylindrical_uv
from hifihr_tpu.render.texture import sample_texture as jsample_texture
from hifihr_tpu_torch.render.texture import cylindrical_uv, sample_texture
from torch_port_helpers import (fake_K, nimble_slice_batch, nimble_step_runs, posed_mano_verts,
                                posed_nimble_verts, rel_l2)

B, S = 8, 32
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "iou",
          "bone_direc")  # bench.py:46-49
CFG = dict(pretrain="res18", hand_model="nimble", render=True, light_estimation=False, image_size=S,
           aa_factor=3, aa_mode="msaa", nimble_corner_tex=False, compute_dtype="float32", losses=LOSSES,
           init_lr=1e-3)
FIRED = LOSSES + ("texture_self", "mrgb_self", "ssim_tex_self", "texture", "mrgb", "ssim_tex", "total")
ZERO_GRAD_BIASES = {"hand_encoder.base_fc0.bias": "hand_encoder.base_fc0.weight",
                    "hand_encoder.base_fc1.bias": "hand_encoder.base_fc1.weight"}


def _t(x):
    return torch.tensor(np.asarray(x))


def _texture_case(seed=0):
    rng = np.random.RandomState(seed)
    tex = rng.rand(2, 16, 12, 7).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (2, 5, 6, 2)).astype(np.float32)
    uv[0, 0, :3] = [[0.0, 0.0], [1.0, 1.0], [0.5, 1.0]]  # the corners and an edge
    uv[1, 0, :2] = [[3 / 11, 5 / 15], [1.0, 0.0]]  # on texel centres
    return tex, uv, rng.randn(2, 5, 6, 7).astype(np.float32)


def test_sample_texture_matches_jax():
    tex, uv, g = _texture_case()

    def jloss(t, u):
        out = jsample_texture(t, u)
        return jnp.sum(out * g), out

    (_, ref), (gt_j, gu_j) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(tex),
                                                                                   jnp.asarray(uv))
    t, u = _t(tex).requires_grad_(), _t(uv).requires_grad_()
    out = sample_texture(t, u)
    assert out.shape == (2, 5, 6, 7)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)
    (out * _t(g)).sum().backward()
    for name, got, want in (("texture", t.grad, gt_j), ("uv", u.grad, gu_j)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), err_msg=name)
    # the sample's weights sum to one: a unit cotangent sends 1 per sample and channel
    t2 = _t(tex).requires_grad_()
    sample_texture(t2, _t(uv)).sum().backward()
    np.testing.assert_allclose(t2.grad.sum().item(), 2 * 5 * 6 * 7, rtol=1e-6)


def test_sample_texture_against_grid_sample():
    """torch's grid_sample computes the same bilinear sample, up to the
    rounding of its grid mapping."""
    tex, uv, _ = _texture_case(1)
    ours = sample_texture(_t(tex), _t(uv))
    lib = Fn.grid_sample(_t(tex).permute(0, 3, 1, 2), 2.0 * _t(uv) - 1.0, mode="bilinear",
                         padding_mode="border", align_corners=True).permute(0, 2, 3, 1)
    assert lib.shape == ours.shape
    np.testing.assert_allclose(lib.numpy(), ours.numpy(), atol=1e-5)


def test_cylindrical_uv_matches_jax():
    verts = np.random.RandomState(0).randn(100, 3).astype(np.float32)
    for axis in (0, 1, 2):
        ref = np.asarray(jcylindrical_uv(jnp.asarray(verts), axis=axis))
        out = cylindrical_uv(_t(verts), axis=axis).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)
        assert (out >= 0).all() and (out <= 1).all()


@pytest.fixture(scope="module")
def nimble_scene():
    """Two posed NIMBLE hands at 32 px: screen projection, faces and atlas
    corners in the renderer's Morton order, and the port's plain K1
    selection."""
    from hifihr_tpu.render.raster_jax import project_to_screen as jax_project
    from hifihr_tpu_torch.hand.nimble import NimbleLayer
    from hifihr_tpu_torch.render.raster_msaa import rasterize_msaa_plain
    from hifihr_tpu_torch.render.renderer import morton_face_order

    tl = NimbleLayer()
    order = morton_face_order(tl.v_template_np, tl.faces_np)
    faces, face_uv = tl.faces_np[order], tl.face_uv_np[order]
    verts = posed_nimble_verts(2, seed=3)
    vs = np.asarray(jax_project(jnp.asarray(verts), jnp.asarray(fake_K(2, S))))
    fid, _, _ = rasterize_msaa_plain(_t(vs), torch.tensor(faces).long(), S)
    return vs, faces, face_uv, fid.numpy()


def test_fragment_interpolate_static_corner_channel(nimble_scene):
    """The atlas corners as a static channel, with per-vertex and batched
    per-corner channels beside it (UV after the vertex channels, before the
    batched ones, as in JAX): values and gradients."""
    from hifihr_tpu.render.interpolate import fragment_interpolate as jfn
    from hifihr_tpu_torch.render.interpolate import fragment_interpolate

    vs, faces, face_uv, fid = nimble_scene
    rng = np.random.RandomState(7)
    Bs, F = fid.shape[0], faces.shape[0]
    attrs = rng.randn(Bs, vs.shape[1], 6).astype(np.float32)
    corner = rng.rand(Bs, F, 3, 7).astype(np.float32)
    covered = fid >= 0
    assert 0.05 < covered.mean() < 0.95
    g_pix = rng.randn(Bs, S, S, 15).astype(np.float32)
    g_z = rng.randn(Bs, S, S).astype(np.float32)

    def jloss(vs, attrs, corner):
        pix, mask, zbuf = jfn(jnp.asarray(fid), vs, jnp.asarray(faces), attrs,
                              corner_attrs_static=jnp.asarray(face_uv), corner_attrs_batched=corner)
        return jnp.sum(pix * g_pix) + jnp.sum(jnp.where(covered, zbuf, 0.0) * g_z), (pix, mask, zbuf)

    (_, (pj, mj, zj)), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(vs), jnp.asarray(attrs), jnp.asarray(corner))
    leaves = [_t(x).requires_grad_() for x in (vs, attrs, corner)]
    pt, mt, zt = fragment_interpolate(_t(fid), leaves[0], torch.tensor(faces).long(), leaves[1],
                                      corner_attrs_static=_t(face_uv), corner_attrs_batched=leaves[2])
    assert pt.shape == (Bs, S, S, 15)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=1e-5)
    uv = pt.detach().numpy()[..., 6:8][covered]
    assert uv.min() >= 0.0 and uv.max() <= 1.0 and uv.std() > 0.01  # interpolated atlas coordinates
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(zt.detach().numpy()[covered], np.asarray(zj)[covered], rtol=1e-6)
    ((pt * _t(g_pix)).sum() + (torch.where(_t(covered), zt, torch.zeros_like(zt)) * _t(g_z)).sum()).backward()
    for name, leaf, ref in zip(("verts_screen", "vert_attrs", "corner_attrs"), leaves, grads_j):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=1e-5 * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("mode", ["msaa", "ssaa"])
def test_renderer_vertex_uv_chart(mode, monkeypatch):
    """The UV path with a per-vertex chart only (`uv_in_verts`): two posed
    MANO meshes, cylindrical_uv of the template, a 7-channel texture
    (diffuse, normal map, spec weight). Both packages shade the port's
    plain face choice; values, and gradients to the vertices and the
    texture."""
    from hifihr_tpu.render.renderer import PhongRenderer as JRenderer, RenderSettings as JSettings
    from hifihr_tpu_torch.assets import load_mano_model
    from hifihr_tpu_torch.render import raster as traster
    from hifihr_tpu_torch.render import raster_msaa as tmsaa
    from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings, _scale_intrinsics

    m = load_mano_model()
    chart = cylindrical_uv(_t(m.v_template)).numpy()
    verts = posed_mano_verts(2, seed=5)
    rng = np.random.RandomState(11)
    tex = rng.rand(2, 16, 16, 7).astype(np.float32)
    g = rng.randn(2, S, S, 5).astype(np.float32)
    K = fake_K(2, S)
    tr = PhongRenderer(m.faces, m.v_template, RenderSettings(S, 3, mode), vert_uv=chart)
    vs = traster.project_to_screen(_t(verts), _t(K))
    if mode == "msaa":
        fid, cov, _ = tmsaa.rasterize_msaa_plain(vs, tr.faces, S)
        monkeypatch.setattr(JRenderer, "_select_faces_msaa",
                            lambda self, v, K: (jnp.asarray(fid.numpy()), jnp.asarray(cov.numpy())))
    else:
        big = traster.project_to_screen(_t(verts), _scale_intrinsics(_t(K), 3.0))
        fid, zb = traster.rasterize_face_id_plain(big, tr.faces, 3 * S)
        monkeypatch.setattr(JRenderer, "_select_faces",
                            lambda self, v, K, b: (jnp.asarray(fid.numpy()), jnp.asarray(zb.numpy())))
    jr = JRenderer(m.faces, JSettings(S, 3, aa_mode=mode, with_depth=True), vert_uv=jnp.asarray(chart),
                   sort_template=m.v_template)
    zero = np.zeros((2, 778, 3), np.float32)

    def jloss(v, t):
        out = jr(v, jnp.asarray(zero), jnp.asarray(K), texture_image=t)
        return jnp.sum(out * g), out

    (_, ref), grads_j = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(verts), jnp.asarray(tex))
    leaves = [_t(verts).requires_grad_(), _t(tex).requires_grad_()]
    out = tr(leaves[0], _t(zero), _t(K), texture_image=leaves[1])
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, S, S, 5)
    assert 0.05 < (ref[..., 3] > 0).mean() < 0.95 and ref[..., :3].max() > 0.1
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    (out * _t(g)).sum().backward()
    for name, leaf, want in zip(("verts", "texture"), leaves, grads_j):
        assert np.abs(np.asarray(want)).max() > 0, name
        assert rel_l2(leaf.grad.numpy(), want) < 1e-4, (name, rel_l2(leaf.grad.numpy(), want))


@pytest.fixture(scope="module")
def runs():
    return nimble_step_runs(CFG, nimble_slice_batch(B, S))


def test_uv_own_face_choice(runs):
    jax_run, port_run = runs
    assert len(port_run["faces"]) == 3
    for what, own, ref in zip(("eval", "train step 1", "train step 2"), port_run["faces"], jax_run["faces"]):
        assert 0.05 < (ref >= 0).mean() < 0.95, what
        assert (own == ref).mean() >= 0.995, (what, (own != ref).sum())


@pytest.mark.parametrize("key", ["joints", "mano_verts", "j2d", "pose_params", "shape_params", "trans", "scale"])
def test_uv_eval_step_geometry_and_params(runs, key):
    ref, out = runs[0]["eval"], runs[1]["eval"]
    assert set(out) == set(ref)
    np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key", ["re_img", "re_depth", "re_sil"])
def test_uv_eval_step_render(runs, key):
    ref, out = runs[0]["eval"][key], runs[1]["eval"][key]
    assert out.shape == ref.shape and np.all(np.isfinite(out))
    assert 0.05 < (runs[0]["eval"]["re_sil"] > 0).mean() < 0.95 and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_uv_train_step_loss_terms(runs):
    jax_run, port_run = runs
    for step in range(2):
        jl, pl = jax_run["loss"][step], port_run["loss"][step]
        assert set(pl) == set(jl) == set(FIRED) | {"skipped"}
        assert pl["skipped"] == jl["skipped"] == 0.0
        for k in FIRED:
            rtol = 1e-4 if step == 0 or k == "total" else 1e-2
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, err_msg=f"step {step + 1} {k}")
    assert port_run["step"] == 2


def test_uv_train_step_gradients(runs):
    jax_run, port_run = runs
    jg, tg = jax_run["grads"], port_run["grads"]
    assert set(jg) == set(tg)
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        if name in ZERO_GRAD_BIASES:
            scale = np.linalg.norm(jg[ZERO_GRAD_BIASES[name]].numpy())
            assert np.linalg.norm(a) < 1e-6 * scale and np.linalg.norm(b) < 1e-6 * scale, name
        elif not b.any():  # outputs no loss reads: the trans and scale heads
            assert not a.any(), name
        else:
            assert rel_l2(a, b) < 1e-3, (name, rel_l2(a, b))
    # the render's gradient reached the appearance coefficients through the sampled maps
    assert np.linalg.norm(tg["hand_encoder.tex_out.weight"].numpy()) > 0
