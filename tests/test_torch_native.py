"""The port's native image libraries (hifihr_tpu_torch/data/native.py:
csrc/imgwarp.cpp, csrc/jpeg_libjpeg.cpp) and its Pillow fallback against the
JAX package's (hifihr_tpu/data/native.py, native/imgproc.cpp) and the numpy
warp.

Tolerances: the port's libjpeg decode and its warps (float32 and uint8
output) equal the JAX package's bit for bit (the same C++ built with the same
flags on one host); on uint8 frames the native warp's float32 output lies
within 1/255 + 1e-6 of the numpy path's (float32 coordinates against
float64), its uint8 output within 2 levels of the numpy path's rounded one
(16.16 fixed-point coordinates and 8-bit weights: up to 1/256 px of position
on a noise frame's steepest edges, and the rounding); Pillow's decode, the
fallback where libjpeg does not build, equals the libjpeg decode bit for bit
here (Pillow's own libjpeg, the same default IDCT and upsampling).
"""

import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

from hifihr_tpu.data import native as jnative
from hifihr_tpu.geometry import crops as jcrops
from hifihr_tpu_torch.data import native
from hifihr_tpu_torch.geometry import crops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _frames(seed: int = 0):
    """Seeded RGB and grayscale frames: smooth ramps and noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:120, 0:160]
    ramp = np.stack([x * 1.5, y * 2, (x + y)], axis=-1).astype(np.uint8)
    noise = (rng.rand(97, 131, 3) * 255).astype(np.uint8)
    return [ramp, noise, noise[..., 0]]


def test_libraries_build_under_build_dir():
    got = native.available()
    assert got["decoder"] == "libjpeg"  # libjpeg and its header are installed here
    build = os.path.join(ROOT, "build", "hifihr_tpu_torch")
    assert os.path.dirname(got["warp"]) == build
    for name in native.LIBRARIES:
        out = native.library_path(name)
        assert os.path.dirname(out) == build and "native" not in os.path.relpath(out, ROOT).split(os.sep)


@pytest.mark.parametrize("kw", [dict(quality=92), dict(quality=75, subsampling=0), dict(quality=95, progressive=True)])
def test_libjpeg_decode_bit_equal_to_jax(kw):
    assert jnative.available()
    for arr in _frames():
        data = _jpeg(arr, **kw)
        got = native.decode_jpeg(data)
        want = jnative.decode_jpeg(data)
        assert got.dtype == np.uint8 and got.shape == arr.shape[:2] + (3,)
        assert got.tobytes() == want.tobytes()


def test_decode_raises_on_a_corrupt_stream():
    data = _jpeg(_frames()[1], quality=90)
    with pytest.raises(ValueError, match="decode failed"):
        native.decode_jpeg(data[:300])
    with pytest.raises(ValueError, match="decode failed"):
        native.decode_jpeg(data, max_h=64, max_w=64)  # larger than the buffer


@pytest.mark.parametrize("out_u8", [False, True])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_warp_batch_bit_equal_to_jax(out_u8, channels):
    rng = np.random.RandomState(channels)
    imgs = (rng.rand(4, 70, 90, channels) * 255).astype(np.uint8)
    affines = np.stack([crops.get_affine_transform(np.asarray([45, 35]), 50 + 10 * i, [48, 40], rot=0.4 * i)[0]
                        for i in range(4)])
    for n_threads in (0, 1):
        got = native.warp_affine_batch(imgs, affines, (48, 40), n_threads=n_threads, out_u8=out_u8)
        want = jnative.warp_affine_batch(imgs, affines, (48, 40), n_threads=n_threads, out_u8=out_u8)
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


def test_native_warp_within_its_bound_of_the_numpy_path():
    """FreiHAND's train augmentation (a random rotation about the centre of
    a 224^2 noise frame) through the native warp and the numpy path."""
    rng = np.random.RandomState(7)
    aug = np.random.RandomState(0)
    for _ in range(4):
        img = (rng.rand(224, 224, 3) * 255).astype(np.uint8)
        aff, _ = crops.get_affine_transform(np.asarray([112, 112]), 224, [224, 224],
                                            rot=aug.uniform(-np.pi, np.pi))
        as_float = img.astype(np.float32) / 255.0
        got = crops.transform_img(img, aff, [224, 224])
        ref = crops.transform_img(as_float, aff, [224, 224])
        assert np.abs(got - ref).max() <= 1 / 255 + 1e-6
        got = crops.transform_img(img, aff, [224, 224], out_u8=True)
        ref = crops.transform_img(as_float, aff, [224, 224], out_u8=True)
        assert np.abs(got.astype(np.int32) - ref).max() <= 2
        assert ref.tobytes() == jcrops.transform_img(as_float, aff, [224, 224], out_u8=True).tobytes()


@pytest.mark.parametrize("kw", [dict(quality=92), dict(quality=75, subsampling=0), dict(quality=95, progressive=True)])
def test_pillow_decode_bit_equal_to_libjpeg(kw):
    for arr in _frames():
        data = _jpeg(arr, **kw)
        got = native.decode_jpeg(data, using="pil")
        assert got.dtype == np.uint8 and got.shape == arr.shape[:2] + (3,)
        assert got.tobytes() == native.decode_jpeg(data, using="libjpeg").tobytes()
    with pytest.raises(ValueError, match="decode failed"):
        native.decode_jpeg(data[:300], using="pil")


def test_decoder_falls_back_to_pillow(monkeypatch):
    """Where libjpeg does not build, the decoder is Pillow; with no Pillow
    either, picking one raises."""
    def no_libjpeg(name):
        raise RuntimeError("building jpeg_libjpeg.cpp failed (rc=1):\nfatal error: jpeglib.h: No such file")

    monkeypatch.setattr(native, "load", no_libjpeg)
    monkeypatch.setattr(native, "_decoder", None)
    assert native.decoder() == "pil"
    data = _jpeg(_frames()[0], quality=92)
    assert native.decode_jpeg(data).tobytes() == native.decode_jpeg(data, using="pil").tobytes()
    monkeypatch.setattr(native, "_decoder", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        native.decoder()
