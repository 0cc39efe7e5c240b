"""Shared inputs for the parity tests of hifihr_tpu_torch against hifihr_tpu.

Inputs are made from numpy seeds and handed to both packages as numpy arrays.
"""

from __future__ import annotations

import numpy as np


def fake_K(batch: int, size: int) -> np.ndarray:
    """The synthetic batch's intrinsics (__graft_entry__._fake_batch)."""
    f = size * 1.8
    K = np.asarray([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32)
    return np.tile(K[None], (batch, 1, 1))


def numpy_tree(tree) -> dict:
    return {k: numpy_tree(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


def randomize_variables(variables: dict, seed: int) -> dict:
    """Flax variables as numpy, as the flax init made them, with random
    BatchNorm running stats, MMPool mix and vertex albedo, so every
    converted tensor matters."""
    rng = np.random.RandomState(seed)
    v = numpy_tree(variables)

    def walk(tree):
        for k, x in tree.items():
            if hasattr(x, "items"):
                walk(x)
            elif k == "mean":
                tree[k] = (rng.randn(*x.shape) * 0.1).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    walk(v.get("batch_stats", {}))
    v["params"]["encoder"]["mmpool"]["p"] = rng.randn(1).astype(np.float32)
    if "vert_tex" in v["params"]:
        v["params"]["vert_tex"] = (rng.randn(778, 3) * 0.3).astype(np.float32)
    return v


def jax_msaa_select_op_by_op(self, verts_cam, K_base):
    """Stands in for hifihr_tpu's PhongRenderer._select_faces_msaa: the
    Pallas MSAA kernel in interpret mode (the JAX CPU path otherwise emulates
    MSAA from an SSAA raster, which picks faces by another rule), run op by
    op in a host callback. Under jit, XLA contracts the projection's and the
    prep's multiply-adds and can move a face id on an edge-on subsample;
    op by op every operation rounds on its own, as in the port. The callback
    takes stop-gradient inputs, so it also runs inside jax.grad."""
    import jax
    import jax.numpy as jnp

    from hifihr_tpu.render import raster_jax
    from hifihr_tpu.render.raster_msaa import rasterize_msaa_pallas

    size, samples = self.settings.image_size, self.settings.aa_factor

    def host(verts, K, faces):
        with jax.disable_jit():
            vs = raster_jax.project_to_screen(jnp.asarray(verts), jnp.asarray(K))
            fid, cov, _ = rasterize_msaa_pallas(vs, jnp.asarray(faces), size, samples=samples,
                                                interpret=True)
        return np.asarray(fid), np.asarray(cov)

    b = verts_cam.shape[0]
    out = (jax.ShapeDtypeStruct((b, size, size), jnp.int32),
           jax.ShapeDtypeStruct((b, size, size), jnp.float32))
    return jax.pure_callback(host, out, jax.lax.stop_gradient(verts_cam),
                             jax.lax.stop_gradient(K_base), self.faces)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b||."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def posed_mano_verts(batch: int, seed: int, z: float = 0.5) -> np.ndarray:
    """Posed MANO meshes in camera space (JAX ManoLayer, small random pose
    and shape), root at z."""
    import jax.numpy as jnp

    from hifihr_tpu.hand.mano import ManoLayer

    rng = np.random.RandomState(seed)
    mano = ManoLayer(ncomps=45)
    pose = jnp.asarray(rng.randn(batch, 48) * 0.3, jnp.float32)
    beta = jnp.asarray(rng.randn(batch, 10) * 0.5, jnp.float32)
    return np.asarray(mano(pose, beta).verts) + np.asarray([0.0, 0.0, z], np.float32)
