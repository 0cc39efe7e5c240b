"""Gradients of the port's differentiable modules on the train step's path
against `jax.grad` of their JAX counterparts, on the same numpy inputs and
cotangents (CPU, fp32): MANO, the perspective projection, vertex normals,
fragment_interpolate (through K2 and its backward K3), Phong shading, the
light estimator, and the whole MSAA render under the photometric losses.

Tolerance: relative L2 error 1e-4 per gradient (fp32 sums in another order
through up to ~20 operations; measured 6e-8 to 5e-6). The renderer is held
with JAX selecting faces op by op (torch_port_helpers.jax_msaa_select_op_by_op):
under jit, XLA's multiply-add contraction moved one edge-on pixel of 8192 to
the neighbouring face, which moved its vertices' gradient by 8%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hifihr_tpu_torch.assets import load_mano_model
from torch_port_helpers import fake_K, jax_msaa_select_op_by_op, posed_mano_verts, rel_l2

TOL = 1e-4


def _t(x):
    return torch.tensor(np.asarray(x), requires_grad=True)


def _grads_match(jfn, tfn, inputs, cotangent_seed=0):
    """Pull one random cotangent per output back through both functions."""
    jin = [jnp.asarray(x) for x in inputs]
    jout, vjp = jax.vjp(jax.jit(jfn), *jin)
    jout = jout if isinstance(jout, tuple) else (jout,)
    rng = np.random.RandomState(cotangent_seed)
    cts = [rng.randn(*o.shape).astype(np.float32) for o in jout]
    jg = vjp(tuple(jnp.asarray(c) for c in cts) if len(cts) > 1 else jnp.asarray(cts[0]))
    tin = [_t(x) for x in inputs]
    tout = tfn(*tin)
    tout = tout if isinstance(tout, tuple) else (tout,)
    torch.autograd.backward([o for o in tout], [torch.tensor(c) for c in cts])
    for i, (a, b) in enumerate(zip(tin, jg)):
        assert rel_l2(a.grad.numpy(), b) < TOL, (i, rel_l2(a.grad.numpy(), b))


def test_mano_and_projection_gradients():
    from hifihr_tpu.geometry.projection import perspective_project as jproject
    from hifihr_tpu.hand.mano import ManoLayer as JMano
    from hifihr_tpu.hand.mano import regress_joints_frei as jregress
    from hifihr_tpu_torch.geometry.projection import perspective_project
    from hifihr_tpu_torch.hand.mano import ManoLayer, regress_joints_frei

    jm, tm = JMano(ncomps=45), ManoLayer(ncomps=45)
    rng = np.random.RandomState(0)
    pose = (rng.randn(2, 48) * 0.5).astype(np.float32)
    beta = rng.randn(2, 10).astype(np.float32)
    K = jnp.asarray(fake_K(2, 224))

    def jfn(p, b):
        out = jm(p, b)
        joints = jregress(out.verts, jm.J_regressor)
        return out.verts, joints, out.full_pose, jproject(joints + jnp.asarray([0.0, 0.0, 0.5]), K)

    def tfn(p, b):
        out = tm(p, b)
        joints = regress_joints_frei(out.verts, tm.J_regressor)
        return (out.verts, joints, out.full_pose,
                perspective_project(joints + torch.tensor([0.0, 0.0, 0.5]), torch.tensor(np.asarray(K))))

    _grads_match(jfn, tfn, [pose, beta])


def test_vertex_normals_gradient():
    from hifihr_tpu.render.mesh import vertex_normals as jfn
    from hifihr_tpu_torch.render.mesh import vertex_normals

    faces = np.asarray(load_mano_model().faces)
    _grads_match(lambda v: jfn(v, jnp.asarray(faces)),
                 lambda v: vertex_normals(v, torch.tensor(faces).long()), [posed_mano_verts(2, seed=1)])


def test_fragment_interpolate_gradient_through_k2_and_k3():
    from hifihr_tpu.render.interpolate import fragment_interpolate as jfn
    from hifihr_tpu_torch.utils.profiling import counters
    from hifihr_tpu_torch.render.interpolate import fragment_interpolate
    from hifihr_tpu_torch.render.raster import project_to_screen
    from hifihr_tpu_torch.render.raster_msaa import rasterize_msaa_plain
    from hifihr_tpu_torch.render.renderer import morton_face_order

    m = load_mano_model()
    faces = np.asarray(m.faces, np.int64)[morton_face_order(m.v_template, m.faces)]
    vs = project_to_screen(torch.tensor(posed_mano_verts(2, seed=2)), torch.tensor(fake_K(2, 32)))
    fid = rasterize_msaa_plain(vs, torch.tensor(faces), 32)[0].numpy()
    covered = fid >= 0
    attrs = np.random.RandomState(2).rand(2, 778, 6).astype(np.float32)

    def jf(v, a):  # zbuf is inf on background; it enters the model masked
        pix, _, z = jfn(jnp.asarray(fid), v, jnp.asarray(faces), a)
        return pix, jnp.where(covered, z, 0.0)

    def tf(v, a):
        pix, _, z = fragment_interpolate(torch.tensor(fid), v, torch.tensor(faces), a)
        return pix, torch.where(torch.tensor(covered), z, torch.zeros_like(z))

    launches = counters["gather_rows.launches"], counters["scatter_rows.launches"]
    _grads_match(jf, tf, [vs.numpy(), attrs])
    assert (counters["gather_rows.launches"], counters["scatter_rows.launches"]) == launches  # plain versions


def test_phong_shade_gradient():
    from hifihr_tpu.render.shading import DirectionalLight as JLight, phong_shade as jfn
    from hifihr_tpu_torch.render.shading import DirectionalLight, phong_shade

    rng = np.random.RandomState(3)
    texels = rng.rand(2, 16, 16, 3).astype(np.float32)
    normals = rng.randn(2, 16, 16, 3).astype(np.float32)
    points = (rng.randn(2, 16, 16, 3) * 0.05 + [0, 0, 0.5]).astype(np.float32)
    colors = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    dirs = rng.randn(2, 3).astype(np.float32)
    _grads_match(lambda t, n, p, c, d: jfn(t, n, p, JLight.from_estimator(c, d)),
                 lambda t, n, p, c, d: phong_shade(t, n, p, DirectionalLight.from_estimator(c, d)),
                 [texels, normals, points, colors, dirs])


def test_light_estimator_gradient():
    from hifihr_tpu.networks.heads import LightEstimator as JLight
    from hifihr_tpu_torch.convert import state_dict_from_flax
    from hifihr_tpu_torch.networks.heads import LightEstimator

    rng = np.random.RandomState(4)
    low = np.maximum(rng.randn(2, 28, 28, 128), 0).astype(np.float32)  # post-ReLU features
    params = jax.jit(JLight().init)(jax.random.PRNGKey(4), jnp.asarray(low))["params"]
    tl = LightEstimator(128)
    tl.load_state_dict(state_dict_from_flax({"params": params}))

    def jfn(x):
        out = JLight().apply({"params": params}, x)
        return out["colors"], out["directions"]

    def tfn(x):
        out = tl(x.permute(0, 3, 1, 2))
        return out["colors"], out["directions"]

    _grads_match(jfn, tfn, [low])


def test_msaa_render_gradient_under_photometric_losses(monkeypatch):
    """verts, vertex albedo and the estimated light through the whole MSAA
    renderer and the six photometric terms (plus sil and iou, which carry no
    gradient), on the same vertices, for 8 posed hands."""
    from hifihr_tpu.config import Config as JConfig
    from hifihr_tpu.losses.stack import LossComputer as JLoss
    from hifihr_tpu.render.renderer import PhongRenderer as JRenderer, RenderSettings as JSettings
    from hifihr_tpu.render.shading import DirectionalLight as JLight
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings
    from hifihr_tpu_torch.render.shading import DirectionalLight

    monkeypatch.setattr(JRenderer, "_select_faces_msaa", jax_msaa_select_op_by_op)
    batch, S = 8, 32
    m = load_mano_model()
    rng = np.random.RandomState(batch)
    verts = posed_mano_verts(batch, seed=8)
    vert_tex = (rng.randn(778, 3) * 0.3).astype(np.float32)
    colors = rng.uniform(-1, 1, (batch, 3)).astype(np.float32)
    dirs = rng.randn(batch, 3).astype(np.float32)
    K = fake_K(batch, S)
    ex = {"imgs": rng.rand(batch, S, S, 3).astype(np.float32),
          "segms_gt": (rng.rand(batch, S, S) > 0.6).astype(np.float32),
          "texture_con": rng.uniform(0.5, 1, batch).astype(np.float32)}
    skin = np.asarray([1.0, 0.2, -0.2], np.float32)
    jr = JRenderer(m.faces, JSettings(S, 3, aa_mode="msaa", with_depth=True), sort_template=m.v_template)
    jloss = JLoss(JConfig(losses=("sil", "iou")))

    def jf(v, vt, c, d):
        albedo = jnp.broadcast_to(jax.nn.sigmoid(vt + skin)[None], (batch, 778, 3))
        rgba = jr(v, albedo, jnp.asarray(K), JLight.from_estimator(c, d))
        sil = (rgba[..., 3:4] > 0).astype(jnp.float32) * 255.0
        out = {"re_img": rgba[..., :3], "re_sil": sil, "maskRGBs": jnp.asarray(ex["imgs"]) * (sil > 0)}
        d = jloss({k: jnp.asarray(x) for k, x in ex.items()}, out, "FreiHand")
        return d["total"], d

    (_, jd), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(x) for x in (verts, vert_tex, colors, dirs)))

    tr = PhongRenderer(m.faces, m.v_template, RenderSettings(S, 3))
    tin = [_t(x) for x in (verts, vert_tex, colors, dirs)]
    albedo = torch.sigmoid(tin[1] + torch.tensor(skin))[None].expand(batch, 778, 3)
    rgba = tr(tin[0], albedo, torch.tensor(K), DirectionalLight.from_estimator(tin[2], tin[3]))
    sil = (rgba[..., 3:4] > 0).float() * 255.0
    out = {"re_img": rgba[..., :3], "re_sil": sil, "maskRGBs": torch.tensor(ex["imgs"]) * (sil > 0)}
    td = LossComputer(Config(losses=("sil", "iou")))({k: torch.tensor(x) for k, x in ex.items()}, out,
                                                     "FreiHand")
    assert set(td) == set(jd) and len(td) == 9
    for k in td:
        np.testing.assert_allclose(td[k].item(), float(jd[k]), rtol=1e-5, err_msg=k)
    td["total"].backward()
    for name, a, b in zip(("verts", "vert_tex", "colors", "directions"), tin, jg):
        assert rel_l2(a.grad.numpy(), b) < TOL, (name, rel_l2(a.grad.numpy(), b))
