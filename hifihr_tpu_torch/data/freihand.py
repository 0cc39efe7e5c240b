"""FreiHAND dataset loader, query-driven, numpy on the host (counterpart of
hifihr_tpu/data/freihand.py: the same samples, byte for byte, from the same
files and seed, and one key more: an evaluation sample carries its root
joint `root_xyz` where evaluation_xyz.json is on disk).

Mirrors the reference's data/dataset.py:1402-1610 (the FreiHand class) and
the FreiHAND branch of HandDataset.get_sample (:160-289):
  * {split}_K.json / _scale.json / _xyz.json / _verts.json / _mano.json
  * 32560 unique training frames x 4 color-augmented versions (130240 images);
    masks and CRF masks exist for the first 32560 only (idx % 32560)
  * trainval split at 30000 (:1436-1451)
  * openpose pseudo-labels from outputs/freihand-train_openpose_keypoints.json
  * train-time random-rotation augmentation producing the trans_* fields with
    the K update K' = post_rot_trans @ K (:222-281)

Images stay uint8 HWC until the warp; the train step normalises on the card.
The augmentation draws from one RandomState(0) per dataset, shared by the
loader's threads, so with threads the draws follow their scheduling, as in
the JAX package; with num_workers=0 both packages draw in the same order.
"""

from __future__ import annotations

import json
import os

import numpy as np

from hifihr_tpu_torch.data import native
from hifihr_tpu_torch.geometry import crops

DB_SIZE_TRAIN = 32560  # reference utils/fh_utils.py:442-449
DB_SIZE_EVAL = 3960
TRAINVAL_SPLIT = 30000
N_COLOR_VERSIONS = 4


def _json_load(path):
    with open(path) as f:
        return json.load(f)


def _load_image(path, as_u8: bool = False) -> np.ndarray:
    """Decode an image file: a JPEG through `native.decode_jpeg` (libjpeg or
    Pillow, which raises on a stream it cannot decode), any other file
    through Pillow, else imageio. `as_u8=True` keeps the raw uint8 pixels
    for the native warp; the default is float32 [0,1] HWC."""
    if str(path).lower().endswith((".jpg", ".jpeg")):
        with open(path, "rb") as f:
            arr = native.decode_jpeg(f.read())
    else:
        try:
            from PIL import Image

            arr = np.asarray(Image.open(path))
        except ImportError:
            import imageio.v2 as imageio

            arr = np.asarray(imageio.imread(path))
        if arr.dtype != np.uint8:  # 16-bit PNGs etc.
            arr = (arr.astype(np.float32) / max(1, np.iinfo(arr.dtype).max
                   if np.issubdtype(arr.dtype, np.integer) else 1) * 255
                   ).astype(np.uint8)
    return arr if as_u8 else arr.astype(np.float32) / 255.0


class FreiHand:
    name = "FreiHand"

    def __init__(
        self,
        base_path: str,
        split: str = "training",  # training | trainval | val | evaluation
        queries: tuple = ("images", "Ks", "joints", "verts", "scales"),
        max_rot: float = np.pi,
        train: bool | None = None,
        semi_ratio: float | None = None,
        four_channel: bool = False,
        db_size: int | None = None,
        n_versions: int = N_COLOR_VERSIONS,
        decode_cache: str | None = None,
    ):
        """`db_size`/`n_versions` override the FreiHAND geometry (32560
        frames x 4 color versions), so FreiHAND-format trees of any size load
        through the same code path.

        `decode_cache` names a directory for a one-time decoded-uint8 mmap
        snapshot of images and masks (data/cache.py): with it, from the
        second epoch on a decode is a page-cache read and only the per-epoch
        random warp remains."""
        self.base_path = base_path
        self.split = split
        self.queries = tuple(queries)
        self.max_rot = max_rot
        self.train = train if train is not None else split in ("training", "trainval")
        self.semi_ratio = semi_ratio
        self.four_channel = four_channel
        self.db_size = int(db_size) if db_size else (
            DB_SIZE_EVAL if split == "evaluation" else DB_SIZE_TRAIN
        )
        self.n_versions = n_versions
        self._rng = np.random.RandomState(0)
        self.decode_cache = decode_cache
        self._img_cache = self._mask_cache = None
        if decode_cache:
            import threading

            self._cache_lock = threading.Lock()

        prefix = "evaluation" if split == "evaluation" else "training"
        self.img_dir = os.path.join(base_path, prefix, "rgb")
        self.mask_dir = os.path.join(base_path, prefix, "mask")
        # CRF-refined masks live beside the dataset (reference
        # data/dataset.py:1433-1434, 1494-1495: CRFmask/{training,evaluation})
        self.crfmask_dir = os.path.join(base_path, "CRFmask", prefix)
        self.K_list = _json_load(os.path.join(base_path, f"{prefix}_K.json"))
        self.scale_list = _json_load(os.path.join(base_path, f"{prefix}_scale.json"))
        if split != "evaluation":
            self.xyz_list = _json_load(os.path.join(base_path, "training_xyz.json"))
            self.verts_list = _json_load(os.path.join(base_path, "training_verts.json"))
            mano_path = os.path.join(base_path, "training_mano.json")
            self.mano_list = _json_load(mano_path) if os.path.exists(mano_path) else None
        else:
            self.xyz_list = self.verts_list = self.mano_list = None
        # the evaluation frames' root joint, where the release's
        # evaluation_xyz.json is on disk: the eval step renders and projects
        # about it. The reference driver passes every batch's root_xyz to
        # the model (train_hrnet.py:62, after traineval_util.py data_dic:21-283
        # builds it) and scores its FreiHAND eval's renders (train_hrnet.py:
        # 148-161); the JAX package's evaluation samples carry no root_xyz, and
        # its eval step raises on them (ROADMAP.md section 3). This is the one
        # key by which the port's samples differ from the JAX package's.
        eval_xyz = os.path.join(base_path, "evaluation_xyz.json")
        self.eval_roots = (np.asarray(_json_load(eval_xyz), np.float32)[:, 9:10]
                           if split == "evaluation" and os.path.exists(eval_xyz) else None)
        open_path = os.path.join(
            base_path, "outputs", "freihand-train_openpose_keypoints.json"
        )
        self.open_2dj = _json_load(open_path) if os.path.exists(open_path) else None

        if split == "training":
            self.indices = np.arange(self.db_size * self.n_versions)
        elif split == "trainval":
            split_at = min(TRAINVAL_SPLIT, self.db_size)
            base = np.arange(split_at)
            self.indices = np.concatenate(
                [base + v * self.db_size for v in range(self.n_versions)]
            )
        elif split == "val":
            self.indices = np.arange(min(TRAINVAL_SPLIT, self.db_size), self.db_size)
        else:
            self.indices = np.arange(self.db_size)

    def __len__(self) -> int:
        return len(self.indices)

    # -- raw accessors -------------------------------------------------------
    def _gt_idx(self, idx: int) -> int:
        return idx % self.db_size if self.split != "evaluation" else idx

    def _cached(self, which: str, n: int, idx: int, decode_fn) -> np.ndarray:
        """Serve frame `idx` through the decoded-uint8 snapshot (lazy init:
        the first decode discovers the frame shape)."""
        cache = getattr(self, f"_{which}_cache")
        if cache is None:
            with self._cache_lock:
                cache = getattr(self, f"_{which}_cache")
                if cache is None:
                    from hifihr_tpu_torch.data.cache import DecodedFrameCache

                    key = f"{self.img_dir}|{which}"
                    cache = DecodedFrameCache.lookup(self.decode_cache, key, n)
                    if cache is None:  # first process ever: decode one frame
                        first = np.ascontiguousarray(decode_fn(), np.uint8)
                        cache = DecodedFrameCache(
                            self.decode_cache, key, n, first.shape
                        )
                        setattr(self, f"_{which}_cache", cache)
                        return cache.get(idx, lambda: first)
                    setattr(self, f"_{which}_cache", cache)
        return cache.get(idx, decode_fn)

    def get_img(self, idx: int, as_u8: bool = False) -> np.ndarray:
        path = os.path.join(self.img_dir, "%08d.jpg" % idx)
        if self.decode_cache:
            n = self.db_size * (1 if self.split == "evaluation" else self.n_versions)
            arr = self._cached("img", n, idx,
                               lambda: _load_image(path, as_u8=True))
            return arr if as_u8 else arr.astype(np.float32) / 255.0
        return _load_image(path, as_u8=as_u8)

    def get_mask(self, idx: int, as_u8: bool = False) -> np.ndarray:
        def decode() -> np.ndarray:
            m = _load_image(
                os.path.join(self.mask_dir, "%08d.jpg" % (idx % self.db_size)),
                as_u8=True,
            )
            if m.ndim == 3:
                m = m[..., 0]
            # binarize before any warp (same threshold as np.round(m/255))
            return (m >= 128).astype(np.uint8) * 255

        if self.decode_cache:
            m = self._cached("mask", self.db_size, idx % self.db_size, decode)
        else:
            m = decode()
        return m if as_u8 else (m > 0).astype(np.float32)

    def get_crfmask(self, idx: int) -> np.ndarray:
        """CRF-refined mask for the base frame (idx % db_size, reference
        data/dataset.py:214-220) as uint8 {0, 255}, binarized at load (the
        reference's round(to_tensor(mask)) thresholds at 127.5 too)."""
        m = _load_image(
            os.path.join(self.crfmask_dir, "%08d.png" % (idx % self.db_size)),
            as_u8=True,
        )
        if m.ndim == 3:
            m = m[..., 0]
        return (m >= 128).astype(np.uint8) * 255

    # -- sample assembly -----------------------------------------------------
    def get_sample(self, i: int) -> dict:
        idx = int(self.indices[i])
        gt = self._gt_idx(idx)
        q = self.queries
        sample: dict = {"idxs": np.int64(idx)}

        image = None  # uint8 until the warp: the native warp fuses u8->f32
        if "images" in q or "trans_images" in q:
            image = self.get_img(idx, as_u8=True)
        if "images" in q:
            sample["imgs"] = image  # uint8; the train step normalises on device
        K = np.asarray(self.K_list[gt], np.float32)
        if "Ks" in q or "trans_Ks" in q:
            sample["Ks"] = K
        if "scales" in q:
            sample["scales"] = np.float32(self.scale_list[gt])
        if self.xyz_list is not None and ("joints" in q or "trans_joints" in q):
            joints = np.asarray(self.xyz_list[gt], np.float32)
            if "joints" in q:
                sample["joints"] = joints
        if self.verts_list is not None and ("verts" in q or "trans_verts" in q):
            verts = np.asarray(self.verts_list[gt], np.float32)
            if "verts" in q:
                sample["verts"] = verts
        if self.mano_list is not None and "manos" in q:
            sample["manos"] = np.asarray(self.mano_list[gt], np.float32)
        if self.open_2dj is not None and ("open_2dj" in q or "trans_open_2dj" in q):
            open_j, open_con = self.open_2dj[idx][:2] if isinstance(
                self.open_2dj[idx], (list, tuple)
            ) else (self.open_2dj[idx], None)
            open_j = np.asarray(open_j, np.float32).reshape(21, -1)[:, :2]
            if open_con is None:
                open_con = np.ones((21, 1), np.float32)
            open_con = np.asarray(open_con, np.float32).reshape(21, 1)
            if "open_2dj" in q:
                sample["open_2dj"] = open_j
                sample["open_2dj_con"] = open_con
        mask = None  # uint8 {0, 255}, binarized at load
        if "masks" in q or "trans_masks" in q:
            mask = self.get_mask(idx, as_u8=True)
            if "masks" in q:
                sample["segms_gt"] = (mask > 0).astype(np.uint8)  # {0,1} u8
        crfmask = None  # uint8 {0, 255} (reference data/dataset.py:214-220)
        if "CRFmasks" in q or "trans_CRFmasks" in q:
            crfmask = self.get_crfmask(idx)
            if "CRFmasks" in q:
                sample["CRFmasks"] = (crfmask > 0).astype(np.uint8)  # {0,1}

        # texture confidence (traineval_util.py:60-66): zero when any keypoint
        # conf <= 0.1, else mean conf; color versions beyond the first get a
        # 0.1x weight (idx>=32560 -> factor 0.1 instead of 1.1)
        if "open_2dj" in sample:
            con = sample["open_2dj_con"][:, 0]
            gate = float(con.min() > 0.1)
            idx_con = 1.1 if idx < self.db_size else 0.1
            sample["texture_con"] = np.float32(gate * float(con.mean()) * idx_con)

        if self.train and "trans_images" in q:
            center = np.asarray([112, 112])
            scale = 224
            rot = self._rng.uniform(-self.max_rot, self.max_rot)
            rot_mat = np.asarray(
                [
                    [np.cos(rot), -np.sin(rot), 0],
                    [np.sin(rot), np.cos(rot), 0],
                    [0, 0, 1],
                ],
                np.float32,
            )
            affinetrans, post_rot_trans = crops.get_affine_transform(
                center, scale, [224, 224], rot=rot
            )
            sample["imgs"] = crops.transform_img(
                image, affinetrans, [224, 224], out_u8=True
            )
            if "trans_Ks" in q:
                sample["Ks"] = (post_rot_trans @ K).astype(np.float32)
            if "trans_joints" in q:
                sample["joints"] = (rot_mat @ joints.T).T
            if "trans_verts" in q:
                sample["verts"] = (rot_mat @ verts.T).T
            if "trans_masks" in q and mask is not None:
                sample["segms_gt"] = (
                    crops.transform_img(mask, affinetrans, [224, 224],
                                        out_u8=True) >= 128
                ).astype(np.uint8)
            if "trans_CRFmasks" in q and crfmask is not None:
                # reference data/dataset.py:261-265: warp, then re-round
                sample["CRFmasks"] = (
                    crops.transform_img(crfmask, affinetrans, [224, 224],
                                        out_u8=True) >= 128
                ).astype(np.uint8)
            if "trans_open_2dj" in q and "open_2dj" in sample:
                sample["open_2dj"] = crops.transform_coords(
                    sample["open_2dj"], affinetrans
                ).astype(np.float32)

        # j2d_gt is DERIVED by projecting (possibly augmented) joints with the
        # (possibly updated) K (traineval_util.py:75-79, 100-104)
        if "joints" in sample and "Ks" in sample:
            uvw = sample["joints"] @ sample["Ks"].T
            sample["j2d_gt"] = (uvw[:, :2] / uvw[:, 2:3]).astype(np.float32)

        # semi-supervision mixing (traineval_util.py:106-111): samples with
        # raw idx below the ratio threshold use GT 2D as pseudo-labels at
        # confidence 1
        if (
            self.semi_ratio is not None
            and "j2d_gt" in sample
            and "open_2dj" in sample
            and gt < self.db_size * self.semi_ratio
        ):
            sample["open_2dj"] = sample["j2d_gt"].copy()
            sample["open_2dj_con"] = np.ones_like(sample["open_2dj_con"])

        if "joints" in sample:
            sample["root_xyz"] = sample["joints"][9:10].copy()
        elif self.eval_roots is not None:
            sample["root_xyz"] = self.eval_roots[gt].copy()

        # 4-channel input: append a gaussian keypoint-heatmap channel built
        # from the openpose detections.  (The reference's four_channel path
        # concatenates raw coordinates onto the image tensor, which cannot
        # work — data/dataset.py:282-289; this is the working equivalent.)
        if self.four_channel and "imgs" in sample and "open_2dj" in sample:
            # heatmap channel is float -> promote imgs to f32 for the concat
            imgs = sample["imgs"]
            if imgs.dtype == np.uint8:
                imgs = imgs.astype(np.float32) / 255.0
            sample["imgs"] = np.concatenate(
                [imgs, keypoint_heatmap_channel(
                    sample["open_2dj"], imgs.shape[0])[..., None]],
                axis=-1,
            )
        return sample


def keypoint_heatmap_channel(j2d: np.ndarray, size: int, sigma: float = 4.0) -> np.ndarray:
    """(21, 2) keypoints -> (size, size) float32 max-of-gaussians heatmap."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    hm = np.zeros((size, size), np.float32)
    for u, v in j2d:
        hm = np.maximum(
            hm, np.exp(-((xs - u) ** 2 + (ys - v) ** 2) / (2 * sigma**2))
        )
    return hm


def sample_version_offset(version: str) -> int:
    """FreiHAND color-version name -> index offset
    (reference utils/fh_utils.py:478-499: gs/hom/sample/auto)."""
    versions = {"gs": 0, "hom": 1, "sample": 2, "auto": 3}
    return versions[version] * DB_SIZE_TRAIN
