"""The port's kernels K1 (MSAA face selection), K2 (per-pixel row gather)
and K3 (its transpose, a segment sum), through their plain PyTorch versions
and the autograd wiring, against the JAX package's Pallas kernels in
interpret mode.

K1: face_id and coverage exactly equal, zbuf at rtol 1e-6 where covered. The
JAX side runs under `jax.disable_jit()`: under jit, XLA's CPU backend fuses
the prep and contracts its multiply-adds, which moves edge coefficients by an
ulp (3 of 8192 face ids flipped on the 64 px MANO scene); op by op, every
operation rounds on its own, as in the port. The interpreted kernel body
still contracts its depth-plane evaluation, which leaves zbuf within 2e-7
relative. K2: rtol 3e-5 / atol 3e-3 against the TPU form, whose hi/lo
bf16 split is good to about 2^-16 (tests/test_gather_mxu.py), and bit-equal
to numpy indexing, since the port's gather is a plain copy. K3: exactly equal
to a numpy segment sum on integer-valued inputs (every partial sum is an
exact fp32 integer), within 1e-6 relative on random ones (fp32 sums in
another order), and at K2's rtol 3e-5 / atol 3e-3 against the TPU form.
The gradients of gather_rows and scatter_rows are each other's forward, so
they are held bit-equal to the other function, and at K2's tolerance to
`jax.vjp` of the TPU kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.render.gather_mxu import gather_rows as jax_gather_rows
from hifihr_tpu.render.gather_mxu import scatter_rows as jax_scatter_rows
from hifihr_tpu.render.raster_jax import project_to_screen as jax_project
from hifihr_tpu.render.raster_msaa import rasterize_msaa_pallas
from hifihr_tpu_torch.assets import load_mano_model
from hifihr_tpu_torch.render import gather as tgather
from hifihr_tpu_torch.render import raster_msaa as traster
from hifihr_tpu_torch.render.renderer import morton_face_order
from hifihr_tpu_torch.utils.profiling import counters
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


def test_k1_bin_edge_scene():
    """The scene chip_smoke.py holds K1's CUDA route against (its tile
    binning): boxes that end on 16 px tile edges and just inside them,
    slivers, a face over four tiles, a face over the screen's edge, two
    identical faces, both windings."""
    from chip_smoke import bin_edge_scene

    vs, faces = bin_edge_scene()
    jax_out, port_out = _k1_both(vs, faces, 64)
    assert set(np.unique(port_out[0]).tolist()) == set(range(-1, 13)) - {10}  # 9 wins the tie
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
    before = counters["rasterize_msaa.launches"], counters["rasterize_msaa.device_launches"]
    out = traster.rasterize_msaa(torch.tensor(vs), torch.tensor(faces).long(), 32)
    ref = traster.rasterize_msaa_plain(torch.tensor(vs), torch.tensor(faces).long(), 32)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert (counters["rasterize_msaa.launches"], counters["rasterize_msaa.device_launches"]) == before  # no kernel launched


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
    before = counters["gather_rows.launches"]
    out = tgather.gather_rows(table, idx)
    assert counters["gather_rows.launches"] == before
    np.testing.assert_array_equal(out[0, :, 0].numpy(), [0, 1, 1, 0, 0, 0])


def _segment_sum(values, idx, F):
    B, _, D = values.shape
    ref = np.zeros((B, F, D), np.float64)
    for b in range(B):
        ok = (idx[b] >= 0) & (idx[b] < F)
        np.add.at(ref[b], idx[b][ok], values[b][ok])
    return ref


def _scanline_idx(B, P, F, rng, dropped=(-1,)):
    """Face ids in scanline order as the train steps' large hand gives them:
    runs of one id from 1 to 3000 rows long (every image holds a run of 3000
    rows), about 85% of rows covered, ids from `dropped` between runs."""
    idx = np.empty((B, P), np.int32)
    for b in range(B):
        p = rng.randint(0, P - 3000)
        idx[b, p:p + 3000] = rng.randint(0, F)
        for lo, hi in ((0, p), (p + 3000, P)):
            while lo < hi:
                n = min(hi - lo, int(rng.choice([1, 2, 3, 40, 300, 1500], p=[.2, .1, .1, .2, .3, .1])))
                idx[b, lo:lo + n] = rng.randint(0, F) if rng.rand() < 0.85 else rng.choice(dropped)
                lo += n
    return idx


@pytest.mark.parametrize("B,F,D,P,layout", [
    pytest.param(2, 37, 9, 300, "random", id="2-37-9-300"),
    pytest.param(2, 1538, 27, 500, "random", id="2-1538-27-500"),
    pytest.param(1, 5000, 7, 400, "random", id="1-5000-7-400"),
    pytest.param(2, 1538, 27, 6000, "runs", id="2-1538-27-6000-runs"),
])
def test_k3_plain_matches_numpy_segment_sum(B, F, D, P, layout):
    rng = np.random.RandomState(F + 1)
    if layout == "runs":
        idx = _scanline_idx(B, P, F, rng, dropped=(-1, F, F + 2))
    else:
        idx = rng.randint(-1, F + 3, size=(B, P)).astype(np.int32)  # -1 and >= F are dropped
    ints = rng.randint(-50, 50, size=(B, P, D)).astype(np.float32)
    out = tgather.scatter_rows_plain(torch.tensor(ints), torch.tensor(idx), F).numpy()
    np.testing.assert_array_equal(out, _segment_sum(ints, idx, F).astype(np.float32))
    vals = rng.randn(B, P, D).astype(np.float32)
    out = tgather.scatter_rows_plain(torch.tensor(vals), torch.tensor(idx), F).numpy()
    ref = _segment_sum(vals, idx, F)
    if layout == "runs":
        # fp32 sums of n terms in any order lie within (n - 1) 2^-24 sum|v|
        # of the exact sum; a run of 3000 rows needs that bound
        n = _segment_sum(np.ones((B, P, 1)), idx, F)
        tol = np.maximum(n - 1, 0) * 2.0**-24 * _segment_sum(np.abs(vals), idx, F)
        assert np.all(np.abs(out - ref) <= tol)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("B,F,D,P,layout", [(2, 37, 9, 300, 0.3), (2, 1538, 27, 2000, 0.5),
                                            (1, 2500, 7, 600, 0.1), (2, 19, 5, 257, 1.0),
                                            (2, 1538, 27, 6000, "runs")])
def test_k3_matches_tpu_scatter(B, F, D, P, layout):
    """F > 1024 spans two TPU table blocks; a layout of 1.0 makes every row
    -1, a float the share of background rows at random, "runs" the train
    steps' long runs of one face id (`_scanline_idx`)."""
    rng = np.random.RandomState(P)
    vals = rng.randn(B, P, D).astype(np.float32)
    if layout == "runs":
        idx = _scanline_idx(B, P, F, rng)
    else:
        idx = rng.randint(0, F, size=(B, P)).astype(np.int32)
        idx[rng.rand(B, P) < layout] = -1
    out = tgather.scatter_rows(torch.tensor(vals), torch.tensor(idx), F).numpy()
    ref = np.asarray(jax_scatter_rows(jnp.asarray(vals), jnp.asarray(idx), F, True))
    if layout == "runs":
        # the TPU form sums hi + lo bf16 halves of each value (each within
        # ~2^-17 of it) in fp32, so its error grows with sum|v| over the
        # run: held at 2^-15 sum|v| per entry
        tol = 2.0**-15 * _segment_sum(np.abs(vals), idx, F)
        assert np.all(np.abs(out - ref) <= tol)
        assert _segment_sum(np.ones((B, P, 1)), idx, F).max() >= 3000
    else:
        np.testing.assert_allclose(out, ref, rtol=3e-5, atol=3e-3)
    if layout == 1.0:
        assert not out.any()


def test_k2_gradient_is_k3_and_matches_jax_vjp():
    rng = np.random.RandomState(5)
    B, F, D, P = 2, 1538, 27, 700
    table, idx = _gather_inputs(B, F, D, P, seed=6)
    ct = rng.randn(B, P, D).astype(np.float32)
    t = torch.tensor(table, requires_grad=True)
    before = counters["scatter_rows.launches"]
    tgather.gather_rows(t, torch.tensor(idx)).backward(torch.tensor(ct))
    assert counters["scatter_rows.launches"] == before  # a CPU tensor takes the plain version
    _, vjp = jax.vjp(lambda x: jax_gather_rows(x, jnp.asarray(idx), True), jnp.asarray(table))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), rtol=3e-5, atol=3e-3)
    np.testing.assert_array_equal(
        t.grad.numpy(), tgather.scatter_rows_plain(torch.tensor(ct), torch.tensor(idx), F).numpy())


def test_k3_gradient_is_k2():
    rng = np.random.RandomState(7)
    B, F, D, P = 2, 37, 9, 300
    vals = torch.tensor(rng.randn(B, P, D).astype(np.float32), requires_grad=True)
    idx = torch.tensor(rng.randint(-1, F, size=(B, P)).astype(np.int32))
    ct = torch.tensor(rng.randn(B, F, D).astype(np.float32))
    tgather.scatter_rows(vals, idx, F).backward(ct)
    assert torch.equal(vals.grad, tgather.gather_rows_plain(ct, idx))
    _, vjp = jax.vjp(lambda v: jax_scatter_rows(v, jnp.asarray(idx.numpy()), F, True),
                     jnp.asarray(vals.detach().numpy()))
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(vjp(jnp.asarray(ct.numpy()))[0]),
                               rtol=3e-5, atol=3e-3)
