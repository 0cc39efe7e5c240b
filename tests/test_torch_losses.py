"""The port's losses (hifihr_tpu_torch/losses/, render/mesh.uniform_laplacian)
against the JAX package's on the same numpy inputs, CPU, fp32.

Tolerances: values and gradients at rtol 1e-5 (fp32 sums and reductions
taken in another order; SSIM's 11x11 convolution sums 121 products per
output); the Laplacian operator exactly equal (both are built in numpy).
JAX takes the derivative of |x| at 0 as 1, torch as 0. In texture_self,
|re_img - maskRGBs| is exactly 0 on background pixels (both are 0 there),
so the gradient with respect to re_img is held where the two differ; on the
model's path the renderer multiplies that gradient by the pixel's zero
coverage, so no parameter sees the difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifihr_tpu.config import Config as JConfig
from hifihr_tpu.losses import basic as jbasic
from hifihr_tpu.losses.ssim import ssim as jssim
from hifihr_tpu.losses.stack import LossComputer as JLossComputer
from hifihr_tpu.render.mesh import uniform_laplacian as juniform_laplacian
from hifihr_tpu.training.steps import make_sched as jmake_sched
from hifihr_tpu_torch.assets import load_mano_model
from hifihr_tpu_torch.config import PORTED_LOSSES, Config
from hifihr_tpu_torch.losses import basic
from hifihr_tpu_torch.losses.ssim import ssim
from hifihr_tpu_torch.losses.stack import LossComputer
from hifihr_tpu_torch.render.mesh import uniform_laplacian
from hifihr_tpu_torch.training.steps import make_sched

FLAGSHIP_LOSSES = ("joint_3d", "joint_2d", "vert_3d", "mscale", "mshape", "mpose",
                   "sil", "iou", "bone_direc")  # bench.py:46-49
FIRED = FLAGSHIP_LOSSES + ("texture_self", "mrgb_self", "ssim_tex_self", "texture", "mrgb",
                           "ssim_tex", "total")


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _both(jfn, tfn, *inputs, grad_args=(0,)):
    """Value and gradient (of the sum) of a loss in both packages."""
    jin = [jnp.asarray(x) for x in inputs]
    jval, jgrads = jax.value_and_grad(lambda *a: jnp.sum(jfn(*a)), argnums=grad_args)(*jin)
    tin = [_t(x, i in grad_args) for i, x in enumerate(inputs)]
    tval = tfn(*tin)
    tval = torch.stack(tval) if isinstance(tval, tuple) else tval
    tval = tval.sum()
    tval.backward()
    tgrads = [tin[i].grad.numpy() for i in grad_args]
    return (float(jval), [np.asarray(g) for g in jgrads]), (tval.item(), tgrads)


def _assert_both(res, rtol=1e-5):
    (jv, jg), (tv, tg) = res
    np.testing.assert_allclose(tv, jv, rtol=rtol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def test_tsa_pose_loss():
    poses = (np.random.RandomState(0).randn(3, 16, 3) * 0.6).astype(np.float32)
    _assert_both(_both(jbasic.tsa_pose_loss, basic.tsa_pose_loss, poses))


def test_bone_direction_loss():
    rng = np.random.RandomState(1)
    j2d = (rng.rand(3, 21, 2) * 224).astype(np.float32)
    ref = (rng.rand(3, 21, 2) * 224).astype(np.float32)
    conf = rng.rand(3, 21, 1).astype(np.float32)
    _assert_both(_both(jbasic.bone_direction_loss, basic.bone_direction_loss, j2d, ref, conf,
                       grad_args=(0, 2)))


def test_edge_length_loss():
    faces = np.asarray(load_mano_model().faces, np.int32)
    rng = np.random.RandomState(2)
    pred = (rng.randn(2, 778, 3) * 0.05).astype(np.float32)
    gt = (rng.randn(2, 778, 3) * 0.05).astype(np.float32)
    _assert_both(_both(lambda p, g: jbasic.edge_length_loss(p, g, faces),
                       lambda p, g: basic.edge_length_loss(p, g, faces), pred, gt))


def test_iou_loss():
    rng = np.random.RandomState(3)
    a = (rng.rand(2, 16, 16) > 0.5).astype(np.float32) * 255.0  # the re_sil / segms_gt unit mix
    b = (rng.rand(2, 16, 16) > 0.4).astype(np.float32)
    _assert_both(_both(jbasic.iou_loss, basic.iou_loss, a, b))


def test_uniform_laplacian_and_laplacian_loss():
    faces = np.asarray(load_mano_model().faces)
    lap = uniform_laplacian(778, faces)
    np.testing.assert_array_equal(lap.numpy(), np.asarray(juniform_laplacian(778, faces)))
    verts = (np.random.RandomState(4).randn(2, 778, 3) * 0.05).astype(np.float32)
    _assert_both(_both(lambda v: jbasic.laplacian_loss(v, jnp.asarray(lap.numpy())),
                       lambda v: basic.laplacian_loss(v, lap), verts))


def test_huber_2d_distance():
    rng = np.random.RandomState(5)
    a = (rng.rand(2, 21, 2) * 20).astype(np.float32)  # distances on both sides of 5 px
    b = (rng.rand(2, 21, 2) * 20).astype(np.float32)
    _assert_both(_both(jbasic.huber_2d_distance, basic.huber_2d_distance, a, b))


def test_chamfer_loss():
    rng = np.random.RandomState(6)
    p = rng.randn(2, 40, 3).astype(np.float32)
    g = rng.randn(2, 30, 3).astype(np.float32)
    _assert_both(_both(lambda a, b: jnp.stack(jbasic.chamfer_loss(a, b)), basic.chamfer_loss, p, g,
                       grad_args=(0, 1)))


def test_ssim():
    rng = np.random.RandomState(7)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    y = np.clip(x + rng.randn(2, 32, 32, 3).astype(np.float32) * 0.1, 0, 1)
    _assert_both(_both(jssim, ssim, x, y, grad_args=(0, 1)))


def _stack_inputs(B=2, S=32, seed=8):
    rng = np.random.RandomState(seed)
    sil = (rng.rand(B, S, S, 1) > 0.6).astype(np.float32) * 255.0
    imgs = rng.rand(B, S, S, 3).astype(np.float32)
    outputs = {
        "joints": (rng.randn(B, 21, 3) * 0.03).astype(np.float32),
        "mano_verts": (rng.randn(B, 778, 3) * 0.03).astype(np.float32),
        "j2d": (rng.rand(B, 21, 2) * S).astype(np.float32),
        "re_img": (rng.rand(B, S, S, 3) * (sil > 0)).astype(np.float32),
        "re_sil": sil,
        "maskRGBs": imgs * (sil > 0),
        "shape_params": rng.randn(B, 10).astype(np.float32),
        "pose_params": rng.randn(B, 48).astype(np.float32),
    }
    examples = {
        "imgs": imgs,
        "j2d_gt": (rng.rand(B, 21, 2) * S).astype(np.float32),
        "joints": (rng.randn(B, 21, 3) * 0.03).astype(np.float32),
        "verts": (rng.randn(B, 778, 3) * 0.03).astype(np.float32),
        "segms_gt": (rng.rand(B, S, S) > 0.5).astype(np.float32),
        "texture_con": rng.uniform(0.5, 1.0, B).astype(np.float32),
    }
    return outputs, examples


DIFFERENTIABLE = ("joints", "mano_verts", "j2d", "re_img", "shape_params", "pose_params")


@pytest.mark.parametrize("cfg", [
    dict(losses=FLAGSHIP_LOSSES),
    dict(losses=("mscale",), losses_frei=FLAGSHIP_LOSSES, base_loss_fn="L1",
         lambda_pose_list=(1e-4, 2e-3), lambda_pose_steps=(3,), lambda_j2d_gt_list=(1e-5, 1e-2),
         lambda_j2d_gt_steps=(2,)),
])
def test_loss_computer_matches_jax(cfg):
    """Every fired term of the flagship set and `total`, and the gradient of
    `total` with respect to each differentiable model output; with stepped
    lambdas from make_sched at epoch 4 and the per-dataset override."""
    outputs, examples = _stack_inputs()
    jcfg, tcfg = JConfig(**cfg), Config(**cfg)
    jsched, tsched = jmake_sched(jcfg, 4), make_sched(tcfg, 4, device="cpu")
    assert {k: float(v) for k, v in jsched.items()} == {k: float(v) for k, v in tsched.items()}

    def jtotal(diff):
        d = JLossComputer(jcfg)({k: jnp.asarray(v) for k, v in examples.items()},
                                {**{k: jnp.asarray(v) for k, v in outputs.items()}, **diff},
                                "FreiHand", jsched)
        return d["total"], d

    (_, jd), jg = jax.value_and_grad(jtotal, has_aux=True)(
        {k: jnp.asarray(outputs[k]) for k in DIFFERENTIABLE})
    tout = {k: _t(v, k in DIFFERENTIABLE) for k, v in outputs.items()}
    td = LossComputer(tcfg)({k: _t(v) for k, v in examples.items()}, tout, "FreiHand", tsched)
    assert set(td) == set(jd) == set(FIRED)
    for k in FIRED:
        np.testing.assert_allclose(td[k].item(), float(jd[k]), rtol=1e-5, err_msg=k)
    td["total"].backward()
    for k in DIFFERENTIABLE:
        ref, got = np.asarray(jg[k]), tout[k].grad.numpy()
        if k == "re_img":
            held = outputs["re_img"] != outputs["maskRGBs"]
            assert held.mean() > 0.3
            ref, got = ref[held], got[held]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max(), err_msg=k)


def test_unported_loss_name_raises():
    for name in ("perceptual", "triangle", "open_2dj", "texture"):
        for field in ("losses", "losses_frei", "losses_rhd"):
            with pytest.raises(NotImplementedError):
                Config(**{field: (name,)})
    Config(losses=PORTED_LOSSES)  # every ported name is accepted
