"""The CPM hand detector in the port (hifihr_tpu_torch/networks/openpose_hand.py)
against the JAX package's: the network at 64^2, the cubic resize at every
detector scale, `HandDetector`'s peaks and confidences, and
`detect_directory`'s JSON. The repo has no CPM weights, so both run on
seeded weights, carried to the port through an `openpose_hand.npz` of
`<layer>_<kind>` keys (the layout tools/convert_openpose.py writes).

Tolerances: the heatmaps within 1e-5 of their largest value; the resize
within 2e-5 on [0, 1] data (`F.interpolate(bicubic, antialias=True)` and
`jax.image.resize(cubic)` weigh the same taps, rounded apart: measured
7.6e-6 at most, 368 -> 552); peaks equal, confidences within 1e-4 relative
(of the largest confidence).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.networks import openpose_hand as jop
from hifihr_tpu_torch.networks.openpose_hand import HandDetector, HandposeCPM, cubic_resize, detect_directory
from hifihr_tpu_torch.networks.openpose_hand import state_dict_from_npz
from torch_port_helpers import seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

S = 64


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """JAX's HandDetector at 64^2 with seeded weights (numpy, biases too, in
    place of its eager flax init, which takes longer than this file), and
    the port's holding the same weights through an npz."""
    shapes = jax.eval_shape(lambda x: jop.HandposeCPM().init(jax.random.PRNGKey(0), x), jnp.zeros((1, S, S, 3)))
    params = seeded_variables(shapes, 6)["params"]
    rng = np.random.RandomState(6)
    for leaves in params.values():
        leaves["bias"] = (rng.randn(*leaves["bias"].shape) * 0.05).astype(np.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jop.HandposeCPM, "init", lambda self, *args, **kwargs: {"params": params})
    try:
        jdet = jop.HandDetector(image_size=S)
    finally:
        mp.undo()
    npz = str(tmp_path_factory.mktemp("cpm") / "openpose_hand.npz")
    np.savez(npz, **{f"{layer}_{kind}": np.asarray(a) for layer, leaves in jdet.params["params"].items()
                     for kind, a in leaves.items()})
    return jdet, HandDetector(image_size=S, device="cpu", npz_path=npz), npz


def test_cpm_network(detectors):
    jdet, det, npz = detectors
    x = np.random.RandomState(0).rand(2, S, S, 3).astype(np.float32) - 0.5
    ref = np.asarray(jax.jit(jdet.model.apply)(jdet.params, jnp.asarray(x)))
    cpm = HandposeCPM()
    cpm.load_state_dict(state_dict_from_npz(npz), strict=True)
    with torch.no_grad():
        out = cpm(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, S // 8, S // 8, 22)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("s", [S, 368])
def test_cubic_resize_at_detector_scales(s):
    """The images down and up to each scale's size, and the stride-8
    heatmaps up to the image, as HandDetector resizes them."""
    rng = np.random.RandomState(s)
    for scale in (0.5, 1.0, 1.5, 2.0):
        size = int(round(s * scale / 8)) * 8
        for src, dst in ((s, size), (size // 8, s)):
            x = rng.rand(1, src, src, 3).astype(np.float32)
            ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, dst, dst, 3), "cubic"))
            out = cubic_resize(torch.tensor(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5, err_msg=f"{src} -> {dst}")


def _check(peaks, conf, jpeaks, jconf):
    np.testing.assert_array_equal(peaks, jpeaks)
    np.testing.assert_allclose(conf, jconf, rtol=0, atol=1e-4 * np.abs(jconf).max())


def test_hand_detector(detectors):
    jdet, det, _ = detectors
    imgs = np.random.RandomState(1).rand(3, S, S, 3).astype(np.float32)
    jpeaks, jconf = jdet(imgs)
    peaks, conf = det(imgs)
    assert peaks.shape == (3, 21, 2) and conf.shape == (3, 21, 1)
    _check(peaks, conf, jpeaks, jconf)


def test_detect_directory(detectors, tmp_path, monkeypatch):
    """Three 64^2 PNGs; both packages' detect_directory on the same weights
    write the same [[coords, conf], ...] in name order."""
    from hifihr_tpu_torch.utils.visualize import write_png

    jdet, det, _ = detectors
    rng = np.random.RandomState(2)
    for name in ("b.png", "a.png", "c.png"):
        write_png(str(tmp_path / name), rng.rand(S, S, 3))
    monkeypatch.setattr(jop, "HandDetector", lambda: jdet)
    jpath = jop.detect_directory(str(tmp_path), str(tmp_path / "jax.json"), batch=3)
    path = detect_directory(str(tmp_path), str(tmp_path / "port.json"), batch=3, detector=det)
    with open(jpath) as f:
        ref = json.load(f)
    with open(path) as f:
        got = json.load(f)
    assert len(got) == len(ref) == 3 and os.path.exists(path)
    _check(np.asarray([g[0] for g in got]), np.asarray([g[1] for g in got]),
           np.asarray([r[0] for r in ref]), np.asarray([r[1] for r in ref]))
