"""Offline converter: the MANO pickle (which holds chumpy objects) -> a plain
npz (counterpart of hifihr_tpu/assets/convert_mano.py):

    python -m hifihr_tpu_torch.assets.convert_mano MANO_RIGHT.pkl \
        hifihr_tpu_torch/assets/mano_right.npz

The reference loads MANO through chumpy at model construction
(utils/mano/webuser/smpl_handpca_wrapper_HAND_only.py:22-67,
utils/my_mano.py:31-33). This runs once, offline, and writes the flat npz
that `hifihr_tpu_torch.assets.load_mano_model` reads. chumpy need not be
installed: the pickle is read with a stub class that keeps each chumpy
object's state. MANO's `shapedirs` is stored as a chumpy select op (an
underlying array `a.x`, flat indices `idxs` and a `preferred_shape`), made
dense here.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np


class _ChStub:
    """Keeps the state of any pickled chumpy object, without chumpy."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChStub
        return super().find_class(module, name)


def _densify(obj) -> np.ndarray:
    """A raw ndarray, scipy sparse matrix or chumpy stub -> a dense array."""
    if isinstance(obj, np.ndarray):
        return obj
    if hasattr(obj, "toarray"):  # scipy sparse
        return np.asarray(obj.toarray())
    if isinstance(obj, _ChStub):
        d = obj.__dict__
        if "x" in d:  # a chumpy.Ch leaf array
            return np.asarray(d["x"])
        if "a" in d and "idxs" in d:  # a chumpy select / reshape op
            out = _densify(d["a"]).ravel()[np.asarray(d["idxs"], dtype=np.int64)]
            shape = d.get("preferred_shape")
            return out.reshape(shape) if shape is not None else out
        raise ValueError(f"Unsupported chumpy object with keys {sorted(d)}")
    raise TypeError(f"Cannot densify {type(obj)}")


def convert(pkl_path: str, npz_path: str) -> dict:
    with open(pkl_path, "rb") as f:
        dd = _StubUnpickler(f, encoding="latin1").load()

    parents = np.asarray(dd["kintree_table"], dtype=np.int64)[0].copy()  # (16,)
    parents[0] = -1  # the root's stored parent is 2^32 - 1
    out = {
        "v_template": _densify(dd["v_template"]).astype(np.float32),  # (778, 3)
        "shapedirs": _densify(dd["shapedirs"]).astype(np.float32),  # (778, 3, 10)
        "posedirs": _densify(dd["posedirs"]).astype(np.float32),  # (778, 3, 135)
        "J_regressor": _densify(dd["J_regressor"]).astype(np.float32),  # (16, 778)
        "lbs_weights": _densify(dd["weights"]).astype(np.float32),  # (778, 16)
        "hands_components": _densify(dd["hands_components"]).astype(np.float32),  # (45, 45)
        "hands_mean": _densify(dd["hands_mean"]).astype(np.float32),  # (45,)
        "faces": np.asarray(dd["f"], dtype=np.int32),  # (1538, 3)
        "parents": parents.astype(np.int32),  # (16,)
    }
    np.savez_compressed(npz_path, **out)
    return out


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit("usage: python -m hifihr_tpu_torch.assets.convert_mano MANO_RIGHT.pkl OUT.npz")
    arrs = convert(sys.argv[1], sys.argv[2])
    for k, v in arrs.items():
        print(f"{k}: {v.shape} {v.dtype}")
    print(f"wrote {sys.argv[2]}")
