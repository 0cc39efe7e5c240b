"""The port's kernels K1 (MSAA face selection) and K2 (per-pixel row gather),
through their plain PyTorch versions, against the JAX package's Pallas
kernels in interpret mode.

K1: face_id and coverage exactly equal, zbuf at rtol 1e-6 where covered. The
JAX side runs under `jax.disable_jit()`: under jit, XLA's CPU backend fuses
the prep and contracts its multiply-adds, which moves edge coefficients by an
ulp (3 of 8192 face ids flipped on the 64 px MANO scene); op by op, every
operation rounds on its own, as in the port. The interpreted kernel body
still contracts its depth-plane evaluation, which leaves zbuf within 2e-7
relative. K2: rtol 3e-5 / atol 3e-3 against the TPU form, whose hi/lo
bf16 split is good to about 2^-16 (tests/test_gather_mxu.py), and bit-equal
to numpy indexing, since the port's gather is a plain copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.render.gather_mxu import gather_rows as jax_gather_rows
from hifihr_tpu.render.raster_jax import project_to_screen as jax_project
from hifihr_tpu.render.raster_msaa import rasterize_msaa_pallas
from hifihr_tpu_torch.assets import load_mano_model
from hifihr_tpu_torch.render import gather as tgather
from hifihr_tpu_torch.render import raster_msaa as traster
from hifihr_tpu_torch.render.renderer import morton_face_order
from torch_port_helpers import fake_K, posed_mano_verts


def _k1_both(vs: np.ndarray, faces: np.ndarray, S: int):
    with jax.disable_jit():
        fj, cj, zj = rasterize_msaa_pallas(jnp.asarray(vs), jnp.asarray(faces), S, samples=3,
                                           interpret=True)
    fp, cp, zp = traster.rasterize_msaa_plain(torch.tensor(vs), torch.tensor(faces).long(), S)
    return (np.asarray(fj), np.asarray(cj), np.asarray(zj)), (fp.numpy(), cp.numpy(), zp.numpy())


def _assert_k1_equal(jax_out, port_out):
    (fj, cj, zj), (fp, cp, zp) = jax_out, port_out
    np.testing.assert_array_equal(fp, fj)
    np.testing.assert_array_equal(cp, cj)
    covered = fj >= 0
    np.testing.assert_allclose(zp[covered], zj[covered], rtol=1e-6)
    assert np.all(np.isinf(zp[~covered])) and np.all(np.isinf(zj[~covered]))


def _one_triangle(S=32):
    # the scene of tests/test_msaa.py
    K = np.asarray([[[float(S), 0, S / 2], [0, float(S), S / 2], [0, 0, 1]]], np.float32)
    verts = np.asarray([[[-0.4, -0.4, 1.0], [0.4, -0.4, 1.0], [0.0, 0.45, 1.0]]], np.float32)
    return np.asarray(jax_project(jnp.asarray(verts), jnp.asarray(K))), np.asarray([[0, 1, 2]],
                                                                                    np.int32)


def _random_mesh(S=32, F=40, V=30, seed=0):
    """Random screen-space mesh with invalid faces: vertices at z <= 1e-6,
    zero-area faces (repeated and collinear corners) and shared edges."""
    rng = np.random.RandomState(seed)
    vs = np.empty((2, V, 3), np.float32)
    vs[..., :2] = rng.uniform(-4, S + 4, (2, V, 2))
    vs[..., 2] = rng.uniform(0.5, 2.0, (2, V))
    vs[:, 0, 2] = 0.0
    vs[:, 1, 2] = 1e-7
    vs[:, 2, 2] = -0.3
    vs[:, 3:6, :2] = [[2.0, 3.0], [10.0, 7.0], [6.0, 5.0]]  # 3, 4, 5 exactly collinear
    faces = rng.randint(0, V, (F, 3)).astype(np.int32)
    faces[0] = (0, 6, 7)
    faces[1] = (8, 1, 9)
    faces[2] = (10, 11, 2)
    faces[3] = (12, 12, 13)
    faces[4] = (3, 4, 5)
    faces[5] = (14, 15, 16)
    faces[6] = (16, 15, 17)  # shares the edge 15-16 with face 5
    return vs, faces


def _mano_scene(S: int, seed: int):
    m = load_mano_model()
    faces = np.asarray(m.faces, np.int32)[morton_face_order(m.v_template, m.faces)]
    verts = posed_mano_verts(2, seed)
    vs = np.asarray(jax_project(jnp.asarray(verts), jnp.asarray(fake_K(2, S))))
    return vs, faces


def test_k1_one_triangle():
    vs, faces = _one_triangle()
    jax_out, port_out = _k1_both(vs, faces, 32)
    assert (port_out[1] == 1.0).sum() > 20 and ((port_out[1] > 0) & (port_out[1] < 1)).any()
    _assert_k1_equal(jax_out, port_out)


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_random_mesh_with_invalid_faces(seed):
    vs, faces = _random_mesh(seed=seed)
    jax_out, port_out = _k1_both(vs, faces, 32)
    for f in range(5):  # z <= 1e-6 or zero area: never selected
        assert not np.any(port_out[0] == f)
    assert (port_out[0] >= 0).mean() > 0.3
    _assert_k1_equal(jax_out, port_out)


@pytest.mark.parametrize("S,seed", [(32, 0), (64, 1)])
def test_k1_posed_mano(S, seed):
    vs, faces = _mano_scene(S, seed)
    jax_out, port_out = _k1_both(vs, faces, S)
    assert (port_out[0] >= 0).mean() > 0.05
    _assert_k1_equal(jax_out, port_out)


def test_k1_prep_matches_tpu_prep():
    """The shared prep's face records equal the TPU prep's packed records,
    bit for bit, when XLA rounds each operation on its own."""
    from hifihr_tpu.render.raster_msaa import _msaa_prep

    vs, faces = _random_mesh(seed=2)
    with jax.disable_jit():
        _, packed, _, _ = _msaa_prep(jnp.asarray(vs), jnp.asarray(faces), 32, 128, 16)
    F = faces.shape[0]
    ref = np.asarray(packed).reshape(2, -1, 16)[:, :F, :15]
    coef, bbox = traster.msaa_prep(torch.tensor(vs), torch.tensor(faces).long())
    np.testing.assert_array_equal(coef.numpy(), ref)
    assert np.all(np.isinf(bbox.numpy()[:, :5]))  # invalid faces: empty boxes


def test_k1_wrapper_takes_plain_version_on_cpu():
    vs, faces = _random_mesh(seed=3)
    before = traster.rasterize_msaa.launches
    out = traster.rasterize_msaa(torch.tensor(vs), torch.tensor(faces).long(), 32)
    ref = traster.rasterize_msaa_plain(torch.tensor(vs), torch.tensor(faces).long(), 32)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert traster.rasterize_msaa.launches == before  # no kernel launched


def test_k1_plain_chunking_keeps_tie_rule(monkeypatch):
    """Face chunks of 1, 3 and all faces give the same selection (the tie
    rule spans chunk boundaries): two coincident faces, lower id wins."""
    vs, faces = _random_mesh(seed=4)
    faces = np.concatenate([faces, faces[7:8]])  # duplicate of face 7 at the end
    results = []
    for elems in (32 * 32 * 2, 3 * 32 * 32 * 2, 1 << 24):
        monkeypatch.setattr(traster, "_PLAIN_CHUNK_ELEMS", elems)
        results.append(traster.rasterize_msaa_plain(torch.tensor(vs), torch.tensor(faces).long(), 32))
    for r in results[1:]:
        for a, b in zip(r, results[0]):
            assert torch.equal(a, b)
    assert not np.any(results[0][0].numpy() == faces.shape[0] - 1)


def _gather_inputs(B, F, D, P, seed):
    rng = np.random.RandomState(seed)
    table = (rng.randn(B, F, D) * 100.0).astype(np.float32)
    idx = rng.randint(-1, F, size=(B, P)).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("B,F,D,P", [(2, 37, 9, 300), (2, 1538, 27, 500), (1, 5000, 7, 400)])
def test_k2_matches_tpu_gather_and_numpy(B, F, D, P):
    table, idx = _gather_inputs(B, F, D, P, seed=F)
    out = tgather.gather_rows_plain(torch.tensor(table), torch.tensor(idx)).numpy()
    ref_tpu = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx), True))
    np.testing.assert_allclose(out, ref_tpu, rtol=3e-5, atol=3e-3)
    ref = table[np.arange(B)[:, None], np.maximum(idx, 0)]
    ref[idx < 0] = 0.0
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))  # bit-equal


def test_k2_out_of_range_rows_are_zero_and_cpu_takes_plain_version():
    table = torch.ones((1, 4, 3))
    idx = torch.tensor([[-1, 0, 3, 4, 7, -5]], dtype=torch.int32)
    before = tgather.gather_rows.launches
    out = tgather.gather_rows(table, idx)
    assert tgather.gather_rows.launches == before
    np.testing.assert_array_equal(out[0, :, 0].numpy(), [0, 1, 1, 0, 0, 0])
