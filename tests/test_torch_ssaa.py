"""The port's SSAA path against the JAX package's on the same numpy inputs
(CPU, fp32): K4 (the supersampled z-buffer face selection) through its plain
version, the SSAA interpolation functions, the SSAA renderer, and the SSAA
slice end to end (eval step and one train step from converted weights).

K4: face_id exactly equal to `raster_jax.rasterize_face_id` run op by op
under `jax.disable_jit()` (zbuf there at rtol 1e-6 where covered, measured
bit-equal) and to the Pallas kernel in interpret mode. The interpreted
kernel body is compiled even under `jax.disable_jit()`, and XLA contracts
its multiply-adds, so its zbuf moves with the rounding of e / area: rtol
1e-5 there (measured 2.4e-6 at 160 px on the random mesh, whose
coordinates reach 164 px; 2.4e-7 on the MANO scene).

Interpolation: the port fetches each pixel's corners through K2, so a
background pixel reads a zero row where JAX reads face 0; bary, tri and
zbuf are held on covered pixels, every masked output everywhere. Values at
rtol 1e-5 (barycentrics near an edge are near 0, so with atol 1e-6),
gradients against `jax.grad` at 1e-4 relative L2.

Renderer and slice: the JAX side selects faces op by op in a host callback
(torch_port_helpers.jax_ssaa_select_op_by_op), so no face id hangs on XLA's
multiply-add contraction. On JAX's own vertices the port picks JAX's faces
at every subsample and agrees within 1e-4 at every output pixel; end to end
the two packages' vertices differ in their last bits, so the render is held
on the output pixels whose 9 subsamples chose the same faces on both sides
(at least 99.9% of them). The train step is held as
tests/test_torch_train_slice.py holds the MSAA one: batch 8, every term
within 1e-4, every gradient within 1e-3 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.render import raster_jax
from hifihr_tpu.render.raster_pallas import rasterize_face_id_pallas
from hifihr_tpu.render.renderer import PhongRenderer as JRenderer
from hifihr_tpu_torch.assets import load_mano_model
from hifihr_tpu_torch.render import raster as traster
from hifihr_tpu_torch.render.renderer import morton_face_order
from hifihr_tpu_torch.utils.profiling import counters
from torch_port_helpers import (fake_K, jax_ssaa_select_op_by_op, one_torch_thread,  # noqa: F401
                                posed_mano_verts, rel_l2, seeded_variables)


def _k4_both(vs: np.ndarray, faces: np.ndarray, S: int):
    """(raster_jax op by op, Pallas interpret, port plain), each (face_id, zbuf)."""
    with jax.disable_jit():
        ref = raster_jax.rasterize_face_id(jnp.asarray(vs), jnp.asarray(faces), S)
    pallas = rasterize_face_id_pallas(jnp.asarray(vs), jnp.asarray(faces), S, interpret=True)
    port = traster.rasterize_face_id_plain(torch.tensor(vs), torch.tensor(faces).long(), S)
    return ([np.asarray(x) for x in ref], [np.asarray(x) for x in pallas], [x.numpy() for x in port])


def _assert_k4_equal(ref, port, zbuf_rtol):
    (fr, zr), (fp, zp) = ref, port
    np.testing.assert_array_equal(fp, fr)
    covered = fr >= 0
    np.testing.assert_allclose(zp[covered], zr[covered], rtol=zbuf_rtol)
    assert np.all(np.isinf(zp[~covered])) and np.all(np.isinf(zr[~covered]))


def _random_mesh(S, F=40, V=30, seed=0):
    """Random screen-space mesh over [-4, S + 4]^2 with both windings and
    invalid faces: vertices at z <= 1e-6, zero-area faces (a repeated
    corner, three collinear corners)."""
    rng = np.random.RandomState(seed)
    vs = np.empty((2, V, 3), np.float32)
    vs[..., :2] = rng.uniform(-4, S + 4, (2, V, 2))
    vs[..., 2] = rng.uniform(0.5, 2.0, (2, V))
    vs[:, 0, 2] = 0.0
    vs[:, 1, 2] = 1e-6  # not > 1e-6: invalid
    vs[:, 2, 2] = -0.3
    vs[:, 3:6, :2] = [[2.0, 3.0], [10.0, 7.0], [6.0, 5.0]]  # 3, 4, 5 exactly collinear
    faces = rng.randint(0, V, (F, 3)).astype(np.int32)
    faces[0] = (0, 6, 7)
    faces[1] = (8, 1, 9)
    faces[2] = (10, 11, 2)
    faces[3] = (12, 12, 13)
    faces[4] = (3, 4, 5)
    return vs, faces


def _winding(vs, faces):
    """(B, F) sign of each face's screen area."""
    t = vs[:, faces]  # (B, F, 3, 3)
    ab, ac = t[:, :, 1, :2] - t[:, :, 0, :2], t[:, :, 2, :2] - t[:, :, 0, :2]
    return np.sign(ab[..., 0] * ac[..., 1] - ab[..., 1] * ac[..., 0])


def _mano_faces():
    m = load_mano_model()
    return np.asarray(m.faces, np.int32)[morton_face_order(m.v_template, m.faces)]


def _mano_scene(S: int, seed: int, batch: int = 2):
    verts = posed_mano_verts(batch, seed)
    vs = np.asarray(raster_jax.project_to_screen(jnp.asarray(verts), jnp.asarray(fake_K(batch, S))))
    return vs, _mano_faces()


@pytest.mark.parametrize("S,seed", [(32, 0), (160, 1)])
def test_k4_random_mesh_with_invalid_faces(S, seed):
    """S = 160 is not a multiple of the TPU kernel's 128 px tile (nor of
    the CUDA kernel's 16 px tile)."""
    vs, faces = _random_mesh(S, seed=seed)
    ref, pallas, port = _k4_both(vs, faces, S)
    fid = port[0]
    for f in range(5):  # z <= 1e-6 or zero area: never selected
        assert not np.any(fid == f)
    wind = _winding(vs, faces)
    for b in range(2):  # faces of both windings are selected
        chosen = np.unique(fid[b][fid[b] >= 0])
        assert (wind[b, chosen] > 0).any() and (wind[b, chosen] < 0).any()
    assert (fid >= 0).mean() > 0.3
    _assert_k4_equal(ref, port, zbuf_rtol=1e-6)
    _assert_k4_equal(pallas, port, zbuf_rtol=1e-5)


def test_k4_posed_mano():
    vs, faces = _mano_scene(96, seed=0)
    ref, pallas, port = _k4_both(vs, faces, 96)
    assert (port[0] >= 0).mean() > 0.05
    _assert_k4_equal(ref, port, zbuf_rtol=1e-6)
    _assert_k4_equal(pallas, port, zbuf_rtol=1e-5)


def test_k4_bin_edge_scene():
    """The scene chip_smoke.py holds K4's CUDA route against at its bin,
    tile and warp-footprint edges (32, 16 and 8 x 4 px): boxes that end on
    those edges and just inside them, slivers across tiles, a face over four
    tiles, a face over the screen's edge, two identical faces, both
    windings."""
    from chip_smoke import BIN_EDGE_WINNERS, bin_edge_scene

    vs, faces = bin_edge_scene()
    ref, pallas, port = _k4_both(vs, faces, 64)
    assert set(np.unique(port[0]).tolist()) == BIN_EDGE_WINNERS  # 9 wins the tie
    for b in range(2):  # image 1 mirrors image 0: the other winding
        assert set(np.unique(port[0][b]).tolist()) == BIN_EDGE_WINNERS
    _assert_k4_equal(ref, port, zbuf_rtol=1e-6)
    _assert_k4_equal(pallas, port, zbuf_rtol=1e-5)


def test_k4_nimble_sized_torus():
    """chip_smoke.py's NIMBLE-sized scene (a torus of 11,926 faces whose
    near and far sides overlap), at 48 px on 2 images: face_id and zbuf
    bit-equal to raster_jax op by op (the interpreted Pallas kernel is too
    slow at this face count)."""
    from chip_smoke import torus_scene

    vs, faces = torus_scene(48, 0.4, seed=3, n=2)
    assert faces.shape == (11926, 3)
    with jax.disable_jit():
        fr, zr = raster_jax.rasterize_face_id(jnp.asarray(vs), jnp.asarray(faces), 48)
    fp, zp = traster.rasterize_face_id_plain(torch.tensor(vs), torch.tensor(faces).long(), 48)
    assert 0.2 < (fp >= 0).float().mean().item() < 0.8
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fr))
    np.testing.assert_array_equal(zp.numpy(), np.asarray(zr))


def test_k4_plain_chunking_keeps_tie_rule(monkeypatch):
    """Face chunks of 1, 3 and all faces give the same selection (the tie
    rule spans chunk boundaries): a copy of the most visible face, appended
    last, never wins."""
    S = 32
    vs, faces = _random_mesh(S, seed=4)
    fid = traster.rasterize_face_id_plain(torch.tensor(vs), torch.tensor(faces).long(), S)[0].numpy()
    top = np.bincount(fid[fid >= 0]).argmax()
    faces = np.concatenate([faces, faces[top:top + 1]])
    results = []
    for elems in (S * S * 2, 3 * S * S * 2, 1 << 24):
        monkeypatch.setattr(traster, "_PLAIN_CHUNK_ELEMS", elems)
        results.append(traster.rasterize_face_id_plain(torch.tensor(vs), torch.tensor(faces).long(), S))
    for r in results[1:]:
        for a, b in zip(r, results[0]):
            assert torch.equal(a, b)
    assert np.any(results[0][0].numpy() == top)
    assert not np.any(results[0][0].numpy() == faces.shape[0] - 1)


def test_k4_wrapper_takes_plain_version_on_cpu_and_raises_elsewhere():
    vs, faces = _random_mesh(32, seed=3)
    vs_t, faces_t = torch.tensor(vs), torch.tensor(faces).long()
    before = counters["rasterize_face_id.launches"], counters["rasterize_face_id.device_launches"]
    out = traster.rasterize_face_id(vs_t, faces_t, 32)
    ref = traster.rasterize_face_id_plain(vs_t, faces_t, 32)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out[0].dtype == torch.int32 and out[1].dtype == torch.float32
    # no kernel launched
    assert (counters["rasterize_face_id.launches"], counters["rasterize_face_id.device_launches"]) == before
    with pytest.raises(ValueError, match="unsupported device"):
        traster.rasterize_face_id(vs_t.to("meta"), faces_t.to("meta"), 32)
    with pytest.raises(ValueError, match="CUDA"):
        traster.select_face_id_cuda(traster.face_triangles(vs_t, faces_t), 32)


# --- the SSAA interpolation functions -------------------------------------

@pytest.fixture(scope="module")
def interp_inputs():
    """A 96 px posed MANO scene (2 images), K4's face ids, random vertex and
    per-face-corner attributes."""
    vs, faces = _mano_scene(96, seed=5)
    fid = traster.rasterize_face_id_plain(torch.tensor(vs), torch.tensor(faces).long(), 96)[0].numpy()
    rng = np.random.RandomState(5)
    attrs = rng.randn(2, 778, 9).astype(np.float32)
    face_attrs = rng.rand(faces.shape[0], 3, 2).astype(np.float32)
    return vs, faces, fid, attrs, face_attrs


def _interp_jax(fid, faces):
    from hifihr_tpu.render.interpolate import barycentric_coords, interpolate_attribute, interpolate_face_attribute

    covered = jnp.asarray(fid >= 0)

    def f(vs, attrs, face_attrs):
        frag = barycentric_coords(jnp.asarray(fid), vs, jnp.asarray(faces))
        return (frag["bary"] * covered[..., None], jnp.where(covered, frag["zbuf"], 0.0),
                interpolate_attribute(frag, attrs),
                interpolate_face_attribute(frag, jnp.asarray(fid), face_attrs))

    return f


def _interp_port(fid, faces):
    from hifihr_tpu_torch.render.interpolate import (barycentric_coords, interpolate_attribute,
                                                     interpolate_face_attribute)

    covered = torch.tensor(fid >= 0)

    def f(vs, attrs, face_attrs):
        frag = barycentric_coords(torch.tensor(fid), vs, torch.tensor(faces).long())
        return (frag["bary"] * covered[..., None], torch.where(covered, frag["zbuf"], torch.zeros(())),
                interpolate_attribute(frag, attrs),
                interpolate_face_attribute(frag, torch.tensor(fid), face_attrs))

    return f


def test_barycentric_coords_values(interp_inputs):
    from hifihr_tpu.render.interpolate import barycentric_coords as jfn
    from hifihr_tpu_torch.render.interpolate import barycentric_coords

    vs, faces, fid, _, _ = interp_inputs
    covered = fid >= 0
    assert 0.05 < covered.mean() < 0.95
    ref = {k: np.asarray(x) for k, x in jax.jit(jfn)(jnp.asarray(fid), jnp.asarray(vs), jnp.asarray(faces)).items()}
    out = {k: x.numpy() for k, x in barycentric_coords(torch.tensor(fid), torch.tensor(vs),
                                                       torch.tensor(faces).long()).items()
           if k in ref}
    assert set(out) == set(ref) == {"mask", "bary", "zbuf", "tri", "pix_faces"}
    np.testing.assert_array_equal(out["mask"], ref["mask"])
    np.testing.assert_array_equal(out["pix_faces"], ref["pix_faces"])
    np.testing.assert_array_equal(out["tri"][covered], ref["tri"][covered])
    assert not out["tri"][~covered].any()  # K2's zero rows
    np.testing.assert_allclose(out["bary"][covered], ref["bary"][covered], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["zbuf"][covered], ref["zbuf"][covered], rtol=1e-5)
    assert np.all(np.isinf(out["zbuf"][~covered]))


def test_interpolation_values(interp_inputs):
    vs, faces, fid, attrs, face_attrs = interp_inputs
    ref = jax.jit(_interp_jax(fid, faces))(jnp.asarray(vs), jnp.asarray(attrs), jnp.asarray(face_attrs))
    out = _interp_port(fid, faces)(torch.tensor(vs), torch.tensor(attrs), torch.tensor(face_attrs))
    for name, a, b in zip(("bary", "zbuf", "attrs", "face_attrs"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)
    assert not out[2].numpy()[fid < 0].any() and not out[3].numpy()[fid < 0].any()


def test_interpolation_gradients(interp_inputs):
    """Through K2's plain version and its backward, K3's."""

    vs, faces, fid, attrs, face_attrs = interp_inputs
    inputs = (vs, attrs, face_attrs)
    jout, vjp = jax.vjp(jax.jit(_interp_jax(fid, faces)), *(jnp.asarray(x) for x in inputs))
    rng = np.random.RandomState(6)
    cts = [rng.randn(*o.shape).astype(np.float32) for o in jout]
    jg = vjp(tuple(jnp.asarray(c) for c in cts))
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    launches = counters["gather_rows.launches"], counters["scatter_rows.launches"]
    tout = _interp_port(fid, faces)(*tin)
    torch.autograd.backward(list(tout), [torch.tensor(c) for c in cts])
    assert (counters["gather_rows.launches"], counters["scatter_rows.launches"]) == launches  # plain versions
    for name, a, b in zip(("verts_screen", "attrs", "face_attrs"), tin, jg):
        assert rel_l2(a.grad.numpy(), b) < 1e-4, (name, rel_l2(a.grad.numpy(), b))


# --- the SSAA renderer ------------------------------------------------------

@pytest.fixture(scope="module")
def render_pair():
    """The SSAA renderer of both packages on the same vertices (4 posed
    hands, 32 px, 96 px supersampled), with the gradients of an L1
    photometric loss to verts_cam, vert_colors and the light."""
    from hifihr_tpu.render.renderer import RenderSettings as JSettings
    from hifihr_tpu.render.shading import DirectionalLight as JLight
    from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings
    from hifihr_tpu_torch.render.shading import DirectionalLight

    batch, S = 4, 32
    m = load_mano_model()
    rng = np.random.RandomState(7)
    inputs = (posed_mano_verts(batch, seed=7), rng.rand(batch, 778, 3).astype(np.float32),
              rng.uniform(-1, 1, (batch, 3)).astype(np.float32), rng.randn(batch, 3).astype(np.float32))
    K = fake_K(batch, S)
    img = rng.rand(batch, S, S, 3).astype(np.float32)

    jax_fid = []
    mp = pytest.MonkeyPatch()
    mp.setattr(JRenderer, "_select_faces",
               lambda self, v, K_big, big: jax_ssaa_select_op_by_op(self, v, K_big, big, record=jax_fid))
    try:
        jr = JRenderer(m.faces, JSettings(S, 3, aa_mode="ssaa", with_depth=True), sort_template=m.v_template)

        def jf(v, colors, c, d):
            rgba = jr(v, colors, jnp.asarray(K), JLight.from_estimator(c, d))
            return jnp.abs(rgba[..., :3] - img).mean(), rgba

        (_, jrgba), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True))(
            *(jnp.asarray(x) for x in inputs))
        jfrag, jvs = jr.rasterize(jnp.asarray(inputs[0]), jnp.asarray(K))
    finally:
        mp.undo()

    tr = PhongRenderer(m.faces, m.v_template, RenderSettings(S, 3, aa_mode="ssaa"))
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    rgba = tr(tin[0], tin[1], torch.tensor(K), DirectionalLight.from_estimator(tin[2], tin[3]))
    (rgba[..., :3] - torch.tensor(img)).abs().mean().backward()
    with torch.no_grad():
        port_fid = tr.select_faces_ssaa(torch.tensor(inputs[0]), torch.tensor(K))[0].numpy()
        tfrag, tvs = tr.rasterize(torch.tensor(inputs[0]), torch.tensor(K))
    keys = ("mask", "bary", "zbuf")
    return {"jax_rgba": np.asarray(jrgba), "port_rgba": rgba.detach().numpy(), "jax_fid": jax_fid[-1],
            "port_fid": port_fid, "jax_grads": [np.asarray(g) for g in jg],
            "port_grads": [t.grad.numpy() for t in tin],
            "jax_raster": ({k: np.asarray(jfrag[k]) for k in keys}, np.asarray(jvs)),
            "port_raster": ({k: tfrag[k].numpy() for k in keys}, tvs.numpy())}


def test_ssaa_render_on_jax_vertices(render_pair):
    r = render_pair
    assert r["port_rgba"].shape == r["jax_rgba"].shape == (4, 32, 32, 5)
    np.testing.assert_array_equal(r["port_fid"], r["jax_fid"])
    alpha = r["jax_rgba"][..., 3]
    assert 0.05 < (alpha > 0).mean() < 0.95 and ((alpha > 0) & (alpha < 1)).any()  # pooled edges
    np.testing.assert_allclose(r["port_rgba"], r["jax_rgba"], atol=1e-4)


def test_ssaa_rasterize(render_pair):
    """PhongRenderer.rasterize: the fragments at 96 px of K4's selection."""
    (jfrag, jvs), (tfrag, tvs) = render_pair["jax_raster"], render_pair["port_raster"]
    np.testing.assert_allclose(tvs, jvs, rtol=1e-6)
    np.testing.assert_array_equal(tfrag["mask"], jfrag["mask"])
    covered = jfrag["mask"] > 0
    assert covered.shape == (4, 96, 96) and covered.any()
    np.testing.assert_allclose(tfrag["bary"][covered], jfrag["bary"][covered], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tfrag["zbuf"][covered], jfrag["zbuf"][covered], rtol=1e-5)


@pytest.mark.parametrize("i,name", [(0, "verts_cam"), (1, "vert_colors"), (2, "light_colors"),
                                    (3, "light_directions")])
def test_ssaa_render_gradients(render_pair, i, name):
    a, b = render_pair["port_grads"][i], render_pair["jax_grads"][i]
    assert np.linalg.norm(b) > 0, name
    assert rel_l2(a, b) < 1e-4, (name, rel_l2(a, b))


# --- the SSAA slice end to end ----------------------------------------------

B, S = 8, 32
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "iou",
          "bone_direc")  # bench.py:46-49
CFG = dict(pretrain="res18", hand_model="mano", render=True, light_estimation=False, image_size=S,
           aa_factor=3, aa_mode="ssaa", compute_dtype="float32", losses=LOSSES, init_lr=1e-3)
FIRED = LOSSES + ("texture_self", "mrgb_self", "ssim_tex_self", "texture", "mrgb", "ssim_tex", "total")
ZERO_GRAD_BIASES = {"hand_encoder.base_fc0.bias": "hand_encoder.base_fc0.weight",
                    "hand_encoder.base_fc1.bias": "hand_encoder.base_fc1.weight"}


def _slice_batch():
    """tests/test_torch_train_slice.py's seeded batch."""
    rng = np.random.RandomState(0)
    return {
        "imgs": rng.rand(B, S, S, 3).astype(np.float32),
        "Ks": fake_K(B, S),
        "root_xyz": np.tile(np.asarray([[[0.0, 0.0, 0.5]]], np.float32), (B, 1, 1)),
        "joints": (rng.randn(B, 21, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "j2d_gt": (rng.rand(B, 21, 2) * S).astype(np.float32),
        "verts": (rng.randn(B, 778, 3) * 0.03 + [0, 0, 0.5]).astype(np.float32),
        "segms_gt": (rng.rand(B, S, S) > 0.6).astype(np.float32),
        "texture_con": rng.uniform(0.5, 1.0, B).astype(np.float32),
        "scales": np.full((B,), 0.0282, np.float32),
    }


def _same_subsamples(fid_a, fid_b, a=3):
    """(B, S, S) output pixels whose a x a subsample face ids agree."""
    n, h, w = fid_a.shape
    same = (fid_a == fid_b).reshape(n, h // a, a, w // a, a)
    return same.all(axis=(2, 4))


@pytest.fixture(scope="module")
def slice_runs():
    """Both packages from the same converted weights: the eval step and one
    train step on the seeded batch of 8, with the JAX face choices."""
    from collections import namedtuple

    from hifihr_tpu.config import Config as JConfig
    from hifihr_tpu.losses.stack import LossComputer as JLossComputer
    from hifihr_tpu.models.hifihr import HiFiHR as JModel
    from hifihr_tpu.training.steps import make_eval_step as jmake_eval_step
    from hifihr_tpu.training.steps import make_sched as jmake_sched
    from hifihr_tpu.training.steps import make_train_step as jmake_train_step
    from hifihr_tpu.training.train_state import TrainState as JTrainState
    from hifihr_tpu.training.train_state import make_optimizer as jmake_optimizer
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.convert import state_dict_from_flax
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import HiFiHR
    from hifihr_tpu_torch.training.steps import make_eval_step, make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    batch = _slice_batch()
    jax_fid = []
    mp = pytest.MonkeyPatch()
    mp.setattr(JRenderer, "_select_faces",
               lambda self, v, K_big, big: jax_ssaa_select_op_by_op(self, v, K_big, big, record=jax_fid))
    try:
        jcfg = JConfig(**CFG)
        jm = JModel(config=jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        v = seeded_variables(jax.eval_shape(
            lambda b: jm.init(jax.random.PRNGKey(0), b["imgs"], b["Ks"], b["root_xyz"], train=False), jb), 0)
        state = namedtuple("State", "params batch_stats")(v["params"], v["batch_stats"])
        jeval = {k: np.asarray(x) for k, x in jmake_eval_step(jm, "FreiHand", jcfg)(state, jb).items()}
        jeval_fid = jax_fid[-1]
        state = JTrainState.create(apply_fn=jm.apply, params=v["params"], tx=jmake_optimizer(jcfg, 1000),
                                   batch_stats=v["batch_stats"])
        state, d = jmake_train_step(jm, JLossComputer(jcfg), "FreiHand", jcfg)(state, jb, jmake_sched(jcfg, 0))
        jtrain = {"loss": {k: float(x) for k, x in d.items()},
                  "grads": state_dict_from_flax({"params": jax.tree_util.tree_map(
                      lambda m: np.asarray(m) / (1.0 - 0.9), state.opt_state[0].mu)})}
    finally:
        mp.undo()

    cfg = Config(**CFG)
    model = HiFiHR(cfg)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    tb = {k: torch.tensor(x) for k, x in batch.items()}
    teval = {k: x.numpy() for k, x in make_eval_step(model, "FreiHand", cfg)(tb).items()}
    with torch.no_grad():
        teval_fid = model.renderer.select_faces_ssaa(torch.tensor(teval["mano_verts"]) + tb["root_xyz"],
                                                     tb["Ks"])[0].numpy()
    tstate = create_train_state(model, cfg)
    _, td = make_train_step(model, LossComputer(cfg), "FreiHand", cfg)(tstate, tb, make_sched(cfg, 0, device="cpu"))
    ttrain = {"loss": {k: float(x) for k, x in td.items()},
              "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
    return {"eval": (jeval, teval, jeval_fid, teval_fid), "train": (jtrain, ttrain)}


@pytest.mark.parametrize("key", ["joints", "mano_verts"])
def test_ssaa_eval_step_geometry(slice_runs, key):
    ref, out, _, _ = slice_runs["eval"]
    assert set(out) == set(ref)
    np.testing.assert_allclose(out[key], ref[key], atol=1e-5)


@pytest.mark.parametrize("key", ["re_img", "re_sil", "re_depth"])
def test_ssaa_eval_step_render(slice_runs, key):
    ref, out, jfid, tfid = slice_runs["eval"]
    assert out[key].shape == ref[key].shape and np.all(np.isfinite(out[key]))
    assert 0.05 < (ref["re_sil"] > 0).mean() < 0.95
    same = _same_subsamples(tfid, jfid)
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(out[key][same], ref[key][same], atol=1e-4)


def test_ssaa_train_step_loss_terms(slice_runs):
    jrun, trun = slice_runs["train"]
    assert set(trun["loss"]) == set(jrun["loss"]) == set(FIRED) | {"skipped"}
    assert trun["loss"]["skipped"] == jrun["loss"]["skipped"] == 0.0
    for k in FIRED:
        np.testing.assert_allclose(trun["loss"][k], jrun["loss"][k], rtol=1e-4, err_msg=k)


def test_ssaa_train_step_gradients(slice_runs):
    jrun, trun = slice_runs["train"]
    jg, tg = jrun["grads"], trun["grads"]
    assert set(jg) == set(tg)
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        if name in ZERO_GRAD_BIASES:
            scale = np.linalg.norm(jg[ZERO_GRAD_BIASES[name]].numpy())
            assert np.linalg.norm(a) < 1e-6 * scale and np.linalg.norm(b) < 1e-6 * scale, name
        elif not b.any():  # outputs no loss reads: the rot, trans and scale heads
            assert not a.any(), name
        else:
            assert rel_l2(a, b) < 1e-3, (name, rel_l2(a, b))
    assert np.linalg.norm(tg["vert_tex"].numpy()) > 0  # the render's gradient reached the albedo
