"""The port's real-data loaders (hifihr_tpu_torch/data/{freihand,rhd,ho3d,
dart,cache}.py, geometry/crops.py, train.py::build_loaders) against the JAX
package's, on the CPU, on the JAX tests' fixture trees
(tests/test_real_loaders.py, tests/test_ho3d.py) and on a small tree from
the port's FreiHAND-format writer (data/freihand_tree.py).

Tolerances: every sample's keys, dtypes and bytes equal, drawn in order
(num_workers=0: the augmentation's RandomState is shared by the loader's
threads in both packages, so with threads the draws follow scheduling);
the one exception is DART's `manos`, within 2e-6 absolute, whose root
rotation goes through the port's torch matrix_to_axis_angle, which rounds
its float32 operations apart from JAX's. Both packages decode JPEG with
libjpeg and warp with the same C++ built with the same flags, so their
pixels are equal.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import hifihr_tpu.data.freihand as jfh
from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.data.dart import DARTset as JDART
from hifihr_tpu.data.ho3d import HO3D as JHO3D
from hifihr_tpu.data.rhd import RHD as JRHD
from hifihr_tpu.geometry import crops as jcrops
import hifihr_tpu_torch.data.freihand as pfh
from hifihr_tpu_torch.config import Config
from hifihr_tpu_torch.data.dart import DARTset
from hifihr_tpu_torch.data.freihand_tree import write_freihand_tree
from hifihr_tpu_torch.data.ho3d import HO3D
from hifihr_tpu_torch.data.rhd import RHD
from hifihr_tpu_torch.geometry import crops
from tests.test_ho3d import ho3d_root  # noqa: F401 - fixture
from tests.test_real_loaders import dart_root, freihand_root, rhd_root  # noqa: F401 - fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAPER = os.path.join(ROOT, "configs", "FreiHAND", "full_rhd_freihand.json")
with open(PAPER) as _f:
    _paper = json.load(_f)
TRAIN_Q, VAL_Q = tuple(_paper["train_queries"]), tuple(_paper["val_queries"])
N_TRAIN, N_EVAL = 6, 4


def same_sample(a: dict, b: dict, close: tuple = (), what: str = "", port_only: tuple = ()):
    """The port's sample `a` equals JAX's `b`: the same keys but for
    `port_only` (in `a` alone), types, dtypes and bytes (within 2e-6 for
    the keys in `close`)."""
    assert all(k in a and k not in b for k in port_only), (what, port_only, sorted(a), sorted(b))
    a = {k: v for k, v in a.items() if k not in port_only}
    assert a.keys() == b.keys(), (what, sorted(a), sorted(b))
    for k in a:
        assert type(a[k]) is type(b[k]), (what, k, type(a[k]), type(b[k]))
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k, x.dtype, y.dtype, x.shape, y.shape)
        if k in close:
            np.testing.assert_allclose(x, y, rtol=0, atol=2e-6, err_msg=f"{what} {k}")
        else:
            assert x.tobytes() == y.tobytes(), (what, k, np.abs(x.astype(float) - y.astype(float)).max())


def same_datasets(port, jax_ds, close: tuple = (), port_only: tuple = ()):
    assert len(port) == len(jax_ds)
    for i in range(len(jax_ds)):
        same_sample(port.get_sample(i), jax_ds.get_sample(i), close, f"sample {i}", port_only)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    write_freihand_tree(root, N_TRAIN, N_EVAL, distinct=3, seed=5)
    return root


# -- crops ---------------------------------------------------------------------------

def test_crop_geometry_bit_equal():
    rng = np.random.RandomState(0)
    for _ in range(5):
        pts = rng.rand(21, 2) * 300
        center = rng.rand(2) * 200
        scale, rot = float(rng.uniform(50, 300)), float(rng.uniform(-np.pi, np.pi))
        assert crops.get_annot_scale(pts) == jcrops.get_annot_scale(pts)
        assert (crops.get_annot_center(pts) == jcrops.get_annot_center(pts)).all()
        for p, j in zip(crops.get_affine_transform(center, scale, [224, 224], rot=rot),
                        jcrops.get_affine_transform(center, scale, [224, 224], rot=rot)):
            assert p.dtype == j.dtype and p.tobytes() == j.tobytes()
        t = crops.get_affine_trans_no_rot(center, scale, [224, 160])
        assert t.tobytes() == jcrops.get_affine_trans_no_rot(center, scale, [224, 160]).tobytes()
        for inv in (False, True):
            assert crops.transform_coords(pts, t, inv).tobytes() == jcrops.transform_coords(pts, t, inv).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("out_u8", [False, True])
def test_transform_img_and_resized_crop_bit_equal(dtype, out_u8):
    """The numpy path (float input) and the native one (uint8 input),
    through transform_img and resized_crop, for 3, 1 and 4 channels."""
    rng = np.random.RandomState(1)
    for shape in ((60, 80, 3), (60, 80), (50, 50, 4)):
        img = rng.rand(*shape).astype(np.float32)
        if dtype == "uint8":
            img = (img * 255).astype(np.uint8)
        aff, _ = crops.get_affine_transform(np.asarray([40, 30]), 70.0, [48, 48], rot=0.7)
        got = crops.transform_img(img, aff, [48, 48], out_u8=out_u8)
        want = jcrops.transform_img(img, aff, [48, 48], out_u8=out_u8)
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
        got = crops.resized_crop(img, -5.5, 10.25, 70.0, 70.0, [32, 32], out_u8=out_u8)
        want = jcrops.resized_crop(img, -5.5, 10.25, 70.0, 70.0, [32, 32], out_u8=out_u8)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_color_jitter_bit_equal():
    img = np.random.RandomState(2).rand(24, 24, 3).astype(np.float32)
    kw = dict(brightness=0.3, contrast=0.4, saturation=0.5, hue=0.1)
    got = crops.color_jitter(img, rng=np.random.RandomState(3), **kw)
    want = jcrops.color_jitter(img, rng=np.random.RandomState(3), **kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# -- FreiHAND ------------------------------------------------------------------------

FREI_CASES = {
    "training_paper": dict(split="training", queries=TRAIN_Q),
    "trainval_paper": dict(split="trainval", queries=TRAIN_Q),
    "val_paper": dict(split="val", queries=VAL_Q),
    "evaluation_paper": dict(split="evaluation", queries=VAL_Q, db_size=N_EVAL),
    "trans_open_2dj": dict(split="training", queries=("trans_images", "trans_Ks", "trans_joints", "open_2dj",
                                                      "trans_open_2dj", "scales", "masks")),
    "semi_ratio": dict(split="training", queries=("images", "Ks", "joints", "open_2dj"), semi_ratio=0.5),
    "four_channel": dict(split="training", queries=("trans_images", "trans_Ks", "trans_joints", "open_2dj",
                                                    "trans_open_2dj"), four_channel=True),
}


@pytest.mark.parametrize("case", sorted(FREI_CASES))
def test_freihand_samples_equal(tree, case, monkeypatch):
    kw = dict(FREI_CASES[case])
    kw.setdefault("db_size", N_TRAIN)
    for m in (jfh, pfh):  # a val split of 2 frames
        monkeypatch.setattr(m, "TRAINVAL_SPLIT", 4)
    # the tree has evaluation_xyz.json: the port's evaluation samples carry
    # their root joint, JAX's none
    port_only = ("root_xyz",) if kw["split"] == "evaluation" else ()
    same_datasets(pfh.FreiHand(tree, **kw), jfh.FreiHand(tree, **kw), port_only=port_only)


def test_freihand_evaluation_root_from_evaluation_xyz(tree):
    """The evaluation split's root_xyz is joint 9 of evaluation_xyz.json (as
    a training sample's is of its joints); without the file there is none."""
    with open(os.path.join(tree, "evaluation_xyz.json")) as f:
        xyz = np.asarray(json.load(f), np.float32)
    ds = pfh.FreiHand(tree, split="evaluation", queries=VAL_Q, db_size=N_EVAL)
    for i in range(N_EVAL):
        r = ds.get_sample(i)["root_xyz"]
        assert r.dtype == np.float32 and r.tobytes() == xyz[i, 9:10].tobytes()
    train = pfh.FreiHand(tree, split="training", queries=("joints",), db_size=N_TRAIN, train=False)
    assert train.get_sample(2)["root_xyz"].tobytes() == xyz[2, 9:10].tobytes()  # the tree repeats frames


def test_freihand_crf_masks_equal(freihand_root):  # noqa: F811
    for kw in (dict(queries=("CRFmasks", "masks"), train=False),
               dict(queries=("trans_images", "trans_Ks", "CRFmasks", "trans_CRFmasks"))):
        kw.update(db_size=3, n_versions=1)  # the fixture holds one version
        same_datasets(pfh.FreiHand(freihand_root, **kw), jfh.FreiHand(freihand_root, **kw))


def test_freihand_helpers_equal():
    j2d = np.random.RandomState(4).rand(21, 2).astype(np.float32) * 64
    assert pfh.keypoint_heatmap_channel(j2d, 64).tobytes() == jfh.keypoint_heatmap_channel(j2d, 64).tobytes()
    for v in ("gs", "hom", "sample", "auto"):
        assert pfh.sample_version_offset(v) == jfh.sample_version_offset(v)


def test_freihand_decode_cache_cold_and_warm(tree, tmp_path, monkeypatch):
    """Cold (decoding and filling the snapshot) and warm (a new instance on
    the filled snapshot, with the decoder made to fail) samples equal JAX's
    uncached ones; the JAX package reads the port's snapshot files."""
    from hifihr_tpu.data.cache import DecodedFrameCache as JCache

    kw = dict(split="training", queries=TRAIN_Q + ("masks",), db_size=N_TRAIN)
    cache = str(tmp_path / "dc")
    same_datasets(pfh.FreiHand(tree, decode_cache=cache, **kw), jfh.FreiHand(tree, **kw))

    def boom(path, as_u8=False):
        raise AssertionError(f"decoder called on a cached frame: {path}")

    monkeypatch.setattr(pfh, "_load_image", boom)
    warm = pfh.FreiHand(tree, decode_cache=cache, **kw)
    same_datasets(warm, jfh.FreiHand(tree, **kw))
    assert warm._img_cache.n_filled == N_TRAIN * 4 and warm._mask_cache.n_filled == N_TRAIN
    jc = JCache.lookup(cache, f"{warm.img_dir}|img", N_TRAIN * 4)
    assert jc is not None and np.array_equal(np.asarray(jc.data), np.asarray(warm._img_cache.data))


# -- RHD, HO-3D, DART ----------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_rhd_samples_equal(rhd_root, train):  # noqa: F811
    same_datasets(RHD(rhd_root, train=train), JRHD(rhd_root, train=train))


@pytest.mark.parametrize("split,train,queries", [
    ("training", False, None), ("training", True, ("trans_images", "trans_masks", "manos")),
    ("evaluation", None, None)])
def test_ho3d_samples_equal(ho3d_root, split, train, queries):  # noqa: F811
    root, _ = ho3d_root
    kw = dict(split=split, train=train, seed=3)
    if queries:
        kw["queries"] = queries
    same_datasets(HO3D(root, **kw), JHO3D(root, **kw))


def test_dart_samples_equal(dart_root):  # noqa: F811
    same_datasets(DARTset(dart_root, split="train"), JDART(dart_root, split="train"), close=("manos",))


def test_matrix_to_axis_angle_matches_jax():
    from hifihr_tpu.geometry.rotations import axis_angle_to_matrix as jaa2m
    from hifihr_tpu.geometry.rotations import matrix_to_axis_angle as jm2aa
    from hifihr_tpu_torch.geometry.rotations import matrix_to_axis_angle

    aa = (np.random.RandomState(5).randn(64, 3) * 1.2).astype(np.float32)
    aa[0] = 0.0  # the eps branch
    mats = np.array(jaa2m(aa))
    got = matrix_to_axis_angle(torch.from_numpy(mats)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm2aa(mats)), rtol=0, atol=2e-6)


# -- build_loaders -------------------------------------------------------------------

def _eval_split_copies(rhd, dart):
    """The fixtures hold training frames only: their copies stand in for
    the evaluation splits the configs' val loaders read."""
    if not os.path.exists(os.path.join(rhd, "evaluation")):
        shutil.copytree(os.path.join(rhd, "training"), os.path.join(rhd, "evaluation"))
        os.rename(os.path.join(rhd, "evaluation", "anno_training.pickle"),
                  os.path.join(rhd, "evaluation", "anno_evaluation.pickle"))
    test_dir = os.path.join(dart, "DARTset", "test")
    if not os.path.exists(test_dir):
        shutil.copytree(os.path.join(dart, "DARTset", "train"), test_dir)


LOADER_CONFIGS = {
    "freihand": ("FreiHAND/full_rhd_freihand.json", dict(controlled_exp=True, controlled_size=N_TRAIN)),
    # per-dataset queries (no shipped config sets them): the FreiHAND loader
    # must read train_queries_frei, not train_queries
    "freihand_rhd_per_dataset_queries": ("RHD/fully_superv_rhd_baseline.json", dict(
        train_datasets=["FreiHand", "RHD"], controlled_exp=True, controlled_size=N_TRAIN,
        train_queries_frei=["trans_images", "trans_Ks", "trans_joints", "open_2dj", "trans_open_2dj"])),
    "rhd": ("RHD/fully_superv_rhd_baseline.json", {}),
    "ho3d": ("HO3D/full_rhd_ho3d.json", {}),
    "dart": ("Dart/fully_superv_dart_pretrain.json", {}),
}


@pytest.mark.parametrize("name", sorted(LOADER_CONFIGS))
def test_build_loaders_first_batches_equal(name, tree, rhd_root, ho3d_root, dart_root):  # noqa: F811
    import train as jtrain
    from hifihr_tpu_torch.train import build_loaders

    _eval_split_copies(rhd_root, dart_root)
    rel, over = LOADER_CONFIGS[name]
    over = dict(over, freihand_base_path=tree, rhd_base_path=rhd_root, ho3d_base_path=ho3d_root[0],
                dart_base_path=dart_root, train_batch=1, val_batch=1, num_workers=0)
    path = os.path.join(ROOT, "configs", rel)
    port = build_loaders(Config.from_json(path, **over))
    ref = jtrain.build_loaders(JConfig.from_json(path, **over))
    for p_loader, j_loader in zip(port, ref):
        assert len(p_loader) == len(j_loader)
        p_batches, j_batches = [], []
        for loader, out in ((p_loader, p_batches), (j_loader, j_batches)):
            it = iter(loader)
            out += [next(it) for _ in range(min(2, len(loader)))]
        assert len(p_batches) == 2, len(p_loader)
        for pb, jb in zip(p_batches, j_batches):
            # FreiHAND's evaluation batches: the port's carry the root joint
            port_only = ("root_xyz",) if jb["dataset"] == "FreiHand" and "joints" not in jb else ()
            same_sample(pb, jb, ("manos",) if name == "dart" else (), name, port_only)
    if name == "freihand_rhd_per_dataset_queries":
        assert "open_2dj" in next(iter(port[0].loaders[0]))  # train_queries_frei's key


# -- the train step on each loader's batch -------------------------------------------

S = 32


def _shrink(batch: dict) -> dict:
    """A 224^2 batch at S px (every k-th pixel; K, j2d and the orthographic
    camera scaled with it), as tests/test_dataset_train_integration.py."""
    k = batch["imgs"].shape[1] // S
    out = dict(batch)
    for key in ("imgs", "segms_gt"):
        if key in batch:
            out[key] = batch[key][:, ::k, ::k][:, :S, :S]
    if "Ks" in batch:
        out["Ks"] = np.diag([1 / k, 1 / k, 1]).astype(np.float32) @ batch["Ks"]
    for key in ("j2d_gt", "open_2dj", "ortho_intr"):
        if key in batch:
            out[key] = batch[key] / np.float32(k)
    return out


STEP_CASES = {
    "FreiHand": ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose"),
    "RHD": ("joint_3d", "joint_2d", "scale", "mscale", "mpose", "mshape", "bone_direc"),
    "HO3D": ("joint_3d", "joint_2d", "open_2dj", "mscale", "mshape", "mpose"),
    "Dart": ("joint_3d", "joint_2d", "vert_3d", "mpose", "mshape"),  # the orthographic branch
}


@pytest.mark.parametrize("dat_name", sorted(STEP_CASES))
def test_train_step_on_each_loaders_batch(dat_name, tree, rhd_root, ho3d_root, dart_root):  # noqa: F811
    from hifihr_tpu_torch.data.base import BatchLoader
    from hifihr_tpu_torch.data.pipeline import stage
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    ds = {"FreiHand": lambda: pfh.FreiHand(tree, queries=TRAIN_Q, db_size=N_TRAIN),
          "RHD": lambda: RHD(rhd_root), "HO3D": lambda: HO3D(ho3d_root[0]),
          "Dart": lambda: DARTset(dart_root)}[dat_name]()
    batch = _shrink(next(iter(BatchLoader(ds, batch_size=2, shuffle=False))))
    batch.pop("dataset")
    cfg = Config(pretrain="res18", hand_model="mano", render=False, light_estimation=False, image_size=S,
                 compute_dtype="float32", losses=STEP_CASES[dat_name])
    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg)
    step = make_train_step(model, LossComputer(cfg), dat_name, cfg)
    state, loss = step(state, stage(batch, torch.device("cpu"), None).arrays, make_sched(cfg, 0, "cpu"))
    assert float(loss["skipped"]) == 0.0 and int(state.step) == 1
    assert all(np.isfinite(float(v)) for v in loss.values()), loss
    assert "joint_2d" in loss


def test_ho3d_eval_epoch_pred_json(ho3d_root, tmp_path):  # noqa: F811
    """One HO-3D eval epoch through the port's Trainer writes pred.json as
    the JAX package's dump_predictions writes the same predictions: the
    same keys, lengths, order and bytes."""
    from hifihr_tpu.training.submission import dump_predictions as jdump
    from hifihr_tpu_torch.data.base import BatchLoader
    from hifihr_tpu_torch.models.hifihr import build_model
    from hifihr_tpu_torch.training.loop import Trainer
    from hifihr_tpu_torch.training.steps import make_eval_step

    root, _ = ho3d_root
    cfg = Config(pretrain="res18", hand_model="mano", render=False, light_estimation=False, image_size=224,
                 val_batch=2, compute_dtype="float32", losses=("joint_3d",), base_out_path=str(tmp_path / "out"))
    model = build_model(cfg, device="cpu")
    loader = BatchLoader(HO3D(root, split="evaluation"), batch_size=2, shuffle=False)
    result = Trainer(cfg, model, loader, loader, out_dir=cfg.base_out_path).evaluate(epoch=0)
    with open(result["pred_json"]) as f:
        got = f.read()
    batch = next(iter(BatchLoader(HO3D(root, split="evaluation"), batch_size=2, shuffle=False)))
    from hifihr_tpu_torch.data.pipeline import stage

    arrays = stage({k: v for k, v in batch.items() if k != "dataset"}, torch.device("cpu"), None).arrays
    out = make_eval_step(model, "HO3D", cfg)(arrays)
    want_path = str(tmp_path / "jax_pred.json")
    jdump(want_path, out["joints"].numpy(), out["mano_verts"].numpy(), dat_name="HO3D")
    with open(want_path) as f:
        assert got == f.read()
    xyz, verts = json.loads(got)
    assert np.asarray(xyz).shape == (2, 21, 3) and np.asarray(verts).shape == (2, 778, 3)


# -- the tree writer -----------------------------------------------------------------

def test_tree_writer_layout_and_pixels(tree):
    """The writer's tree holds what FreiHand reads, its frames repeat by
    hard link, and each decodes within a JPEG bound of its source pixels
    (quality 92: mean |delta| below 2 levels)."""
    from hifihr_tpu_torch.data import native
    from hifihr_tpu_torch.data.freihand_tree import source_frames

    src = source_frames(3, seed=5)
    for split, n in (("training", N_TRAIN), ("evaluation", N_EVAL)):
        for i in range(n):
            for kind, ref in (("rgb", src["images"]), ("mask", src["masks"])):
                p = os.path.join(tree, split, kind, "%08d.jpg" % i)
                assert os.stat(p).st_ino == os.stat(os.path.join(tree, split, kind, "%08d.jpg" % (i % 3))).st_ino
                with open(p, "rb") as f:
                    px = native.decode_jpeg(f.read()).astype(np.float64)
                want = ref[i % 3].astype(np.float64)
                px = px if kind == "rgb" else px[..., 0]
                assert np.abs(px - want).mean() < 2.0, (split, kind, i, np.abs(px - want).mean())
    with open(os.path.join(tree, "outputs", "freihand-train_openpose_keypoints.json")) as f:
        assert len(json.load(f)) == N_TRAIN * 4
    s = pfh.FreiHand(tree, queries=("images", "Ks", "joints"), db_size=N_TRAIN, train=False).get_sample(4)
    uvw = s["joints"] @ s["Ks"].T
    np.testing.assert_allclose(uvw[:, :2] / uvw[:, 2:], src["j2d"][1], atol=1e-3)
