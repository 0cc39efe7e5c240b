"""The port's data layer (hifihr_tpu_torch/data/) against the JAX package's
on the CPU: the loaders' order and batches, the synthetic dataset's samples,
and the device prefetch.

Tolerances:
- loaders, Subset and ConcatLoader: batches equal exactly (both packages
  index the same numpy dataset);
- the synthetic dataset's MANO ground truth (verts, joints, and the fields
  computed from them: root_xyz, j2d_gt, open_2dj, scales) within 1e-5
  absolute (metres, and pixels for the 2D fields at 32 px): the two MANO
  layers sum in another order in fp32; every other field (images, masks,
  K, texture_con, open_2dj_con, pose, shape) equal exactly;
- prefetch_to_device on the CPU: every tensor equal to the loader's array.
"""

import numpy as np
import pytest
import torch

from hifihr_tpu.data.base import BatchLoader as JBatchLoader
from hifihr_tpu.data.base import ConcatLoader as JConcatLoader
from hifihr_tpu.data.base import Subset as JSubset
from hifihr_tpu.data.base import collate as jcollate
from hifihr_tpu.data.synthetic import SyntheticHandDataset as JSynthetic
from hifihr_tpu_torch.data.base import BatchLoader, ConcatLoader, Subset, collate
from hifihr_tpu_torch.data.pipeline import prefetch_to_device
from hifihr_tpu_torch.data.synthetic import SyntheticHandDataset

GT_FIELDS = ("joints", "verts", "root_xyz", "j2d_gt", "open_2dj", "scales")


class _Indexed:
    """Sample i carries i and a seeded array; samples in `broken` raise, so
    the loaders substitute them."""

    name = "Indexed"

    def __init__(self, n: int, broken=()):
        self.n = n
        self.broken = set(broken)

    def __len__(self):
        return self.n

    def get_sample(self, idx):
        if idx in self.broken:
            raise OSError(f"corrupt sample {idx}")
        return {"idx": np.int64(idx), "x": np.random.RandomState(idx).rand(3, 2).astype(np.float32),
                "w": np.float64(idx) / 7}


def _same_batches(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
def test_batch_loader_order(workers, shuffle, drop_last):
    """The same batches in the same order for two epochs, with the corrupt
    samples substituted alike, in the main thread and through the pool."""
    ds = _Indexed(23, broken=(4, 17))
    kw = dict(batch_size=5, shuffle=shuffle, seed=3, drop_last=drop_last, num_workers=workers)
    mine, ref = BatchLoader(ds, **kw), JBatchLoader(ds, **kw)
    assert len(mine) == len(ref) == (4 if drop_last else 5)
    for _ in range(2):
        _same_batches(list(mine), list(ref))
    assert mine.epoch == ref.epoch == 2


def test_subset_and_concat_loader():
    """Subset's first-k view and ConcatLoader's round robin, with a member
    that runs out and restarts, over two epochs."""
    a, b = _Indexed(20), _Indexed(9)
    with pytest.warns(UserWarning):
        assert len(Subset(b, 50)) == 9
    mine = ConcatLoader([BatchLoader(Subset(a, 12), 4, seed=1), BatchLoader(b, 4, seed=2, num_workers=2)])
    ref = JConcatLoader([JBatchLoader(JSubset(a, 12), 4, seed=1), JBatchLoader(b, 4, seed=2, num_workers=2)])
    assert len(mine) == len(ref) == 5
    for _ in range(2):
        _same_batches(list(mine), list(ref))


def test_synthetic_dataset():
    mine, ref = SyntheticHandDataset(size=16, image_size=32), JSynthetic(size=16, image_size=32)
    np.testing.assert_allclose(mine.verts, ref.verts, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mine.joints, ref.joints, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mine.faces, np.asarray(ref.faces))
    for k in ("pose", "betas", "K", "root_z"):
        np.testing.assert_array_equal(getattr(mine, k), getattr(ref, k), err_msg=k)
    for idx in range(len(mine)):
        s, r = mine.get_sample(idx), ref.get_sample(idx)
        assert s.keys() == r.keys()
        for k in s:
            assert np.asarray(s[k]).dtype == np.asarray(r[k]).dtype, k
            if k in GT_FIELDS:
                np.testing.assert_allclose(s[k], r[k], rtol=0, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(s[k], r[k], err_msg=k)


def test_prefetch_keeps_order_and_values():
    """On the CPU the prefetch yields the loader's batches in its order as
    torch tensors (64-bit types narrowed, as the JAX package's transfer
    does), with the dataset tag passed through, also when it stops early."""
    ds = _Indexed(40)
    ref = list(BatchLoader(ds, 4, seed=9, num_workers=2))
    got = list(prefetch_to_device(BatchLoader(ds, 4, seed=9, num_workers=2), "cpu", depth=3,
                                  transfer_workers=3))
    assert len(got) == len(ref) == 10
    for g, r in zip(got, ref):
        assert g["dataset"] == r["dataset"] == "Indexed"
        assert g["idx"].dtype == torch.int32 and g["w"].dtype == torch.float32
        np.testing.assert_array_equal(g["idx"].numpy(), r["idx"])
        np.testing.assert_array_equal(g["x"].numpy(), r["x"])
        np.testing.assert_array_equal(g["w"].numpy(), r["w"].astype(np.float32))
    it = prefetch_to_device(BatchLoader(ds, 4, seed=9), "cpu")
    first = next(it)
    it.close()
    np.testing.assert_array_equal(first["idx"].numpy(), ref[0]["idx"])


def test_collate():
    """Scalars and arrays stack (strings too, through np.isscalar); other
    values are listed, as in the JAX package's collate."""
    samples = [{"x": 1.0, "a": np.zeros(3), "s": "u", "o": (1, 2)},
               {"x": 2.0, "a": np.ones(3), "s": "v", "o": (3, 4)}]
    out, ref = collate(samples), jcollate(samples)
    assert out["x"].shape == (2,) and out["a"].shape == (2, 3) and out["o"] == [(1, 2), (3, 4)]
    _same_batches([out], [ref])
