"""The port's eval metrics (hifihr_tpu_torch/training/metrics.py,
losses/lpips.py) against the JAX package's on the CPU, on the same numpy
inputs.

Tolerances:
- align_w_scale and pa_mpjpe on seeded similarity transforms with noise:
  1e-5 relative (atol 1e-7 m on the aligned points); fp32 SVDs of 3x3
  matrices on both sides;
- EvalUtil: equal (the same numpy code on the same errors);
- texture_metrics at 64 px (with LPIPS) and at 16 px (without): 1e-5
  relative, 1e-7 absolute. JAX's random LPIPS weights (its PRNGKey(0) init)
  are carried to both packages through an npz the test writes in the
  converted layout, so both report the key 'lpips';
- the pred.json submission files and the 2D-error report's text and
  means: equal to the JAX package's, byte for byte.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hifihr_tpu.losses.lpips as jlpips
import hifihr_tpu.training.metrics as JM
from hifihr_tpu_torch.losses.lpips import LPIPS
from hifihr_tpu_torch.training import metrics as M


def _similar_pairs(b: int, n: int, seed: int):
    """gt (B, N, 3) and pred = s R gt + t + noise, per item."""
    rng = np.random.RandomState(seed)
    gt = (rng.randn(b, n, 3) * 0.05).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(b, 3, 3))
    q *= np.sign(np.linalg.det(q))[:, None, None]  # proper rotations
    s = rng.uniform(0.5, 2.0, (b, 1, 1))
    t = rng.randn(b, 1, 3) * 0.1
    pred = s * gt @ q.transpose(0, 2, 1) + t + rng.randn(b, n, 3) * 0.004
    return gt, pred.astype(np.float32)


@pytest.mark.parametrize("n", [21, 778])
def test_align_w_scale_and_pa_mpjpe(n):
    gt, pred = _similar_pairs(6, n, seed=n)
    mine = M.align_w_scale(torch.from_numpy(gt), torch.from_numpy(pred)).numpy()
    ref = np.asarray(jax.vmap(JM.align_w_scale)(jnp.asarray(gt), jnp.asarray(pred)))
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-7)
    assert np.abs(mine - gt).max() < 0.02  # the noise, not the transform, is left
    e = float(M.pa_mpjpe(torch.from_numpy(pred), torch.from_numpy(gt)))
    je = float(JM.pa_mpjpe(jnp.asarray(pred), jnp.asarray(gt)))
    np.testing.assert_allclose(e, je, rtol=1e-5)


def test_eval_util():
    gt, pred = _similar_pairs(9, 21, seed=1)
    vis = np.random.RandomState(2).rand(21) > 0.2
    mine, ref = M.EvalUtil(), JM.EvalUtil()
    for ev in (mine, ref):
        ev.feed(gt, pred)
        ev.feed(gt[0], pred[0] * 1.1, vis=vis)
    for a, b in zip(mine.get_measures(), ref.get_measures()):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """JAX's random LPIPS weights in the converted npz layout."""
    net = jlpips.LPIPS()
    z = {}
    for i in range(5):
        z[f"conv{i}_kernel"] = np.asarray(net.net_params["params"][f"conv{i}"]["kernel"])
        z[f"conv{i}_bias"] = np.asarray(net.net_params["params"][f"conv{i}"]["bias"])
        z[f"lin{i}_kernel"] = np.asarray(net.head_params["params"][f"lin{i}"]["kernel"])
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_alex.npz")
    np.savez(path, **z)
    return path


def _render_pair(b: int, s: int, seed: int, u8: bool):
    rng = np.random.RandomState(seed)
    re_img = rng.rand(b, s, s, 3).astype(np.float32)
    re_sil = ((rng.rand(b, s, s, 1) > 0.4) * 255.0).astype(np.float32)
    real = rng.rand(b, s, s, 3)
    real = (real * 255).astype(np.uint8) if u8 else real.astype(np.float32)
    mask = (rng.rand(b, s, s) > 0.5).astype(np.uint8 if u8 else np.float32)
    return re_img, re_sil, real, mask


@pytest.mark.parametrize("size,u8", [(64, False), (64, True), (16, False)])
def test_texture_metrics(size, u8, lpips_npz, monkeypatch):
    arrays = _render_pair(3, size, seed=size, u8=u8)
    monkeypatch.setattr(jlpips, "LPIPS_NPZ", lpips_npz)
    monkeypatch.setattr(JM, "_LPIPS", None)
    ref = {k: float(v) for k, v in JM.texture_metrics(*[jnp.asarray(a) for a in arrays[:3]],
                                                      gt_mask=jnp.asarray(arrays[3])).items()}
    lp = LPIPS(lpips_npz)
    assert lp.pretrained
    mine = {k: float(v) for k, v in M.texture_metrics(*[torch.from_numpy(a) for a in arrays[:3]],
                                                      gt_mask=torch.from_numpy(arrays[3]), lpips=lp).items()}
    want = {"psnr", "ssim", "l1", "l2"} | ({"lpips"} if size >= 64 else set())
    assert set(mine) == set(ref) == want
    for k in want:
        np.testing.assert_allclose(mine[k], ref[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_lpips_random_init_key():
    """Without the npz, LPIPS runs seeded random features with flax's
    initialisers and texture_metrics names its key lpips_randinit."""
    lp = LPIPS(npz_path=None, seed=0)
    assert not lp.pretrained
    for conv in lp.convs:
        w = conv.weight
        std = (1.0 / w[0].numel()) ** 0.5
        assert abs(w.std().item() / std - 1) < 5 / (2 * w.numel()) ** 0.5
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 * (1 + 1e-6) and not conv.bias.any()
    out = M.texture_metrics(*[torch.from_numpy(a) for a in _render_pair(2, 64, seed=0, u8=False)[:3]], lpips=lp)
    assert set(out) == {"psnr", "ssim", "l1", "l2", "lpips_randinit"} and np.isfinite(float(out["lpips_randinit"]))


def test_submission_dump_matches_the_jax_package(tmp_path):
    """pred.json in the FreiHAND and HO3D conventions: the same file as the
    JAX package's dump_predictions writes (HO3D: joints reordered
    Frei->HO3D, y and z negated)."""
    from hifihr_tpu.training.submission import dump_predictions as jdump
    from hifihr_tpu_torch.training.submission import dump_predictions, to_ho3d_convention

    rng = np.random.RandomState(4)
    xyz, verts = rng.randn(3, 21, 3).astype(np.float32), rng.randn(3, 778, 3).astype(np.float32)
    for dat_name in ("FreiHand", "HO3D"):
        mine = dump_predictions(str(tmp_path / f"port_{dat_name}.json"), xyz, verts, dat_name=dat_name)
        ref = jdump(str(tmp_path / f"jax_{dat_name}.json"), xyz, verts, dat_name=dat_name)
        with open(mine) as f, open(ref) as g:
            assert f.read() == g.read()
    assert to_ho3d_convention(xyz)[0, 0, 1] == -xyz[0, 0, 1]


def test_visualize_dumps_match_the_jax_package(tmp_path):
    """write_png writes the JAX package's bytes; the 2D error report its
    text files and means; the prediction grid renders (matplotlib)."""
    from hifihr_tpu.utils import visualize as jviz
    from hifihr_tpu_torch.utils import visualize as viz

    rng = np.random.RandomState(5)
    img = rng.rand(9, 7, 3).astype(np.float32)
    a, b = viz.write_png(str(tmp_path / "a.png"), img), jviz.write_png(str(tmp_path / "b.png"), img)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    errs = {"proj": rng.rand(5, 21).astype(np.float32) * 3}
    means = viz.save_2d_error_report(str(tmp_path / "port"), errs)
    jmeans = jviz.save_2d_error_report(str(tmp_path / "jax"), errs)
    assert means == jmeans
    with open(tmp_path / "port" / "j2d_proj_ED.txt") as f, open(tmp_path / "jax" / "j2d_proj_ED.txt") as g:
        assert f.read() == g.read()
    examples = {"imgs": rng.rand(2, 16, 16, 3), "j2d_gt": rng.rand(2, 21, 2) * 16}
    outputs = {"j2d": rng.rand(2, 21, 2) * 16, "re_img": rng.rand(2, 16, 16, 3),
               "re_sil": (rng.rand(2, 16, 16, 1) > 0.5) * 255.0}
    assert os.path.getsize(viz.save_prediction_grid(str(tmp_path / "grid.png"), examples, outputs)) > 0
