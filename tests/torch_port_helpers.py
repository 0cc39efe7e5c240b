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
