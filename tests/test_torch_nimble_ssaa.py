"""NIMBLE under the SSAA render (`aa_mode="ssaa"`) in the port against the
JAX package: the eval step and two train steps of both packages from the
same converted weights on the same batch, in the slice tests' small
configuration (res18, 32 px, so K4 selects faces at 96^2; no light
estimation, fp32, the flagship's loss set, Adam at lr 1e-3, batch 8). The
render samples NIMBLE's UV maps per fragment, the atlas corners
interpolated by `interpolate_face_attribute`, and the shade pass runs
under `torch.utils.checkpoint` in the train steps.

JAX's SSAA face selection is recorded (raster_jax jitted in a host
callback, torch_port_helpers.jax_ssaa_select_recorded) and the port shades
JAX's choice; its own K4 choice (the plain version here) is held at 99.5%
of the supersampled pixels or more: the two packages' vertices differ in
their last bits, and at NIMBLE's 11,926 faces that can move the nearest
face at a pixel (tests/test_torch_nimble_slice.py). JAX's corner
accumulation takes its fp32 scatter-add fallback.

Tolerances, those of tests/test_torch_nimble_slice.py: eval geometry and
parameters 1e-4, the render 1e-4 absolute; step 1's terms 1e-4 relative
and its gradients 1e-3 relative L2; step 2's total 1e-4 and its terms
1e-2.
"""

import numpy as np
import pytest

from torch_port_helpers import nimble_slice_batch, nimble_step_runs, one_torch_thread, rel_l2  # noqa: F401

B, S = 8, 32
LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose", "sil", "iou",
          "bone_direc")  # bench.py:46-49
CFG = dict(pretrain="res18", hand_model="nimble", render=True, light_estimation=False, image_size=S,
           aa_factor=3, aa_mode="ssaa", compute_dtype="float32", losses=LOSSES, init_lr=1e-3)
FIRED = LOSSES + ("texture_self", "mrgb_self", "ssim_tex_self", "texture", "mrgb", "ssim_tex", "total")
ZERO_GRAD_BIASES = {"hand_encoder.base_fc0.bias": "hand_encoder.base_fc0.weight",
                    "hand_encoder.base_fc1.bias": "hand_encoder.base_fc1.weight"}


@pytest.fixture(scope="module")
def runs():
    return nimble_step_runs(CFG, nimble_slice_batch(B, S), seeded_init=True)


def test_ssaa_own_face_choice(runs):
    jax_run, port_run = runs
    assert len(port_run["faces"]) == 3
    for what, own, ref in zip(("eval", "train step 1", "train step 2"), port_run["faces"], jax_run["faces"]):
        assert own.shape == ref.shape == (B, 3 * S, 3 * S), what
        assert 0.05 < (ref >= 0).mean() < 0.95, what
        assert (own == ref).mean() >= 0.995, (what, (own != ref).sum())


@pytest.mark.parametrize("key", ["joints", "mano_verts", "j2d", "pose_params", "shape_params", "trans", "scale"])
def test_ssaa_eval_step_geometry_and_params(runs, key):
    ref, out = runs[0]["eval"], runs[1]["eval"]
    assert set(out) == set(ref)
    np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("key", ["re_img", "re_depth", "re_sil"])
def test_ssaa_eval_step_render(runs, key):
    ref, out = runs[0]["eval"][key], runs[1]["eval"][key]
    assert out.shape == ref.shape and np.all(np.isfinite(out))
    assert 0.05 < (runs[0]["eval"]["re_sil"] > 0).mean() < 0.95 and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_ssaa_train_step_loss_terms(runs):
    jax_run, port_run = runs
    for step in range(2):
        jl, pl = jax_run["loss"][step], port_run["loss"][step]
        assert set(pl) == set(jl) == set(FIRED) | {"skipped"}
        assert pl["skipped"] == jl["skipped"] == 0.0
        for k in FIRED:
            rtol = 1e-4 if step == 0 or k == "total" else 1e-2
            np.testing.assert_allclose(pl[k], jl[k], rtol=rtol, err_msg=f"step {step + 1} {k}")
    assert port_run["step"] == 2


def test_ssaa_train_step_gradients(runs):
    jax_run, port_run = runs
    jg, tg = jax_run["grads"], port_run["grads"]
    assert set(jg) == set(tg)
    for name, g in tg.items():
        a, b = g.numpy(), jg[name].numpy()
        if name in ZERO_GRAD_BIASES:
            scale = np.linalg.norm(jg[ZERO_GRAD_BIASES[name]].numpy())
            assert np.linalg.norm(a) < 1e-6 * scale and np.linalg.norm(b) < 1e-6 * scale, name
        elif not b.any():  # outputs no loss reads: the trans and scale heads
            assert not a.any(), name
        else:
            assert rel_l2(a, b) < 1e-3, (name, rel_l2(a, b))
    assert np.linalg.norm(tg["hand_encoder.tex_out.weight"].numpy()) > 0
