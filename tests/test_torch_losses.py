"""The port's losses (hifihr_tpu_torch/losses/, render/mesh.uniform_laplacian)
against the JAX package's on the same numpy inputs, CPU, fp32.

Tolerances: values and gradients at rtol 1e-5 (fp32 sums and reductions
taken in another order; SSIM's 11x11 convolution sums 121 products per
output; the perceptual loss runs six fp32 VGG convs, with JAX's random
VGG19 params carried across by the converter); the Laplacian operator exactly equal (both are built in numpy).
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
from hifihr_tpu_torch.losses.ssim import ssim, ssim_partials_plain
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


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 13, 29, 3)])
@pytest.mark.parametrize("with_dy", [True, False])
def test_ssim_partials_plain_matches_autograd(shape, with_dy):
    """K5's arithmetic (separable moments, partial maps, analytic dx and
    dy) against autograd through the plain `ssim`, in float64 so the
    formulas are held and not the rounding: the separable window in fp32
    (K5's) and the dense one (outer product rounded to fp32) differ by
    ~1e-7 relative; a wrong formula or border is off by far more. The
    ragged shape holds the borders (a 13 x 29 image under an 11-tap
    window). Images with flat zero borders, as masked renders have."""
    rng = np.random.RandomState(11)
    x = rng.rand(*shape)
    x[:, :3] = 0.0
    y = np.clip(x + rng.randn(*shape) * 0.1, 0, 1)
    tx, ty = _t(x, True), _t(y, with_dy)
    val = ssim(tx, ty)
    val.backward()
    got = ssim_partials_plain(_t(x), _t(y), with_dy=with_dy)
    np.testing.assert_allclose(got[0].item(), val.item(), rtol=1e-6)
    for g, ref in ((got[1], tx.grad), (got[2], ty.grad if with_dy else None)):
        if ref is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6 * ref.abs().max().item())


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


SEVEN = ("bone_direc_3d", "scale", "open_2dj", "open_bone_direc", "triangle", "tsa_poses", "perceptual")


def _branch_inputs(B=2, S=32, seed=9):
    """Seeded outputs and examples for the seven branches; no re_sil,
    texture_con or segms_gt-driven triple fires, so each case holds its own
    branch alone."""
    rng = np.random.RandomState(seed)
    outputs = {
        "joints": (rng.randn(B, 21, 3) * 0.03).astype(np.float32),
        "mano_verts": (rng.randn(B, 778, 3) * 0.03).astype(np.float32),
        "j2d": (rng.rand(B, 21, 2) * S).astype(np.float32),
        "tsa_poses": (rng.randn(B, 16, 3) * 0.6).astype(np.float32),
        "re_img": rng.rand(B, S, S, 3).astype(np.float32),
    }
    examples = {
        "imgs": rng.rand(B, S, S, 3).astype(np.float32),
        "joints": (rng.randn(B, 21, 3) * 0.03).astype(np.float32),
        "scales": rng.uniform(0.02, 0.04, B).astype(np.float32),
        # pseudo-labels within 5 px of the prediction for some joints, so
        # both sides of the Huber-like distance are held
        "open_2dj": (outputs["j2d"] + rng.randn(B, 21, 2) * 6).astype(np.float32),
        "open_2dj_con": rng.rand(B, 21, 1).astype(np.float32),
        "segms_gt": (rng.rand(B, S, S) > 0.5).astype(np.float32),
    }
    return outputs, examples


@pytest.mark.parametrize("name,dat_name", [(n, "FreiHand") for n in SEVEN] + [("scale", "RHD"), ("scale", "HO3D"),
                                                                                ("tsa_pose", "FreiHand")])
def test_seven_branches_match_jax(name, dat_name):
    """Each of the seven branches alone (bone_direc_3d, scale, open_2dj,
    open_bone_direc, triangle, tsa_poses, perceptual) against JAX's
    LossComputer: the value and the gradient of the total with respect to
    every model output it reads, at rtol 1e-5 (perceptual's six fp32 convs
    with JAX's own random VGG19 params carried across by the converter).
    scale fires for FreiHand and RHD and, under HO3D, neither side fires it
    nor warns; tsa_pose is the singular spelling of tsa_poses."""
    import warnings

    from hifihr_tpu_torch.convert import state_dict_from_flax

    outputs, examples = _branch_inputs()
    cfg = dict(losses=(name,), lambda_scale=100.0, lambda_bone_direc_3d=6.0, lambda_percep=1e-2,
               lambda_pose_list=(1e-2,))
    jlc, tlc = JLossComputer(JConfig(**cfg)), LossComputer(Config(**cfg))
    if name == "perceptual":
        tlc.vgg.load_state_dict(state_dict_from_flax(jlc.vgg_params), strict=True)

    def jtotal(diff):
        d = jlc({k: jnp.asarray(v) for k, v in examples.items()},
                {**{k: jnp.asarray(v) for k, v in outputs.items()}, **diff}, dat_name)
        return d["total"], d

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a fired branch warns on neither side
        (_, jd), jg = jax.value_and_grad(jtotal, has_aux=True)({k: jnp.asarray(v) for k, v in outputs.items()})
        tout = {k: _t(v, True) for k, v in outputs.items()}
        td = tlc({k: _t(v) for k, v in examples.items()}, tout, dat_name)
    fired = {"tsa_pose": "tsa_poses"}.get(name, name)
    want = {"total"} if (name, dat_name) == ("scale", "HO3D") else {fired, "total"}
    assert set(td) == set(jd) == want
    for k in want:
        np.testing.assert_allclose(td[k].item(), float(jd[k]), rtol=1e-5, err_msg=k)
    if want == {"total"}:
        return
    assert td[fired].item() > 0
    td["total"].backward()
    read = [k for k in outputs if tout[k].grad is not None and tout[k].grad.abs().max() > 0]
    assert read, name
    for k in outputs:
        ref = np.asarray(jg[k])
        got = tout[k].grad.numpy() if tout[k].grad is not None else np.zeros_like(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(np.abs(ref).max(), 1e-30), err_msg=k)


def test_unfired_loss_warns_as_jax_does(monkeypatch):
    """A listed loss whose batch key or model output is missing does not
    fire and warns once with the JAX package's message (open_2dj without
    pseudo-labels, tsa_poses without the MANO output, perceptual listed only
    under losses_frei, so no VGG is built)."""
    import warnings

    import hifihr_tpu.losses.stack as jstack

    monkeypatch.setattr(jstack, "_WARNED_UNFIRED", set())
    outputs, examples = _branch_inputs()
    del outputs["tsa_poses"], examples["open_2dj"]
    cfg = dict(losses=("mscale",), losses_frei=("joint_3d", "open_2dj", "tsa_poses", "perceptual"))
    msgs = []
    for lc, wrap in ((JLossComputer(JConfig(**cfg)), jnp.asarray), (LossComputer(Config(**cfg)), _t)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):  # warned once
                d = lc({k: wrap(v) for k, v in examples.items()}, {k: wrap(v) for k, v in outputs.items()},
                       "FreiHand")
        assert set(d) == {"joint_3d", "total"}
        msgs.append([str(w.message) for w in caught if "did not fire" in str(w.message)])
    assert msgs[0] == msgs[1] and len(msgs[1]) == 1, msgs
    assert "['open_2dj', 'tsa_poses', 'perceptual']" in msgs[1][0]


def test_unported_loss_name_raises():
    """Every loss name that JAX's stack reads (each `"<name>" in loss_used`
    of hifihr_tpu/losses/stack.py) is accepted in every loss field, and so
    are the photometric names (texture, mrgb, ssim_tex and their _self
    forms), as JAX's Config accepts them: those triples fire on presence. A
    name that no branch of either stack reads still raises."""
    import re

    import hifihr_tpu.losses.stack as jstack

    with open(jstack.__file__) as f:
        read = set(re.findall(r'"(\w+)" in loss_used', f.read()))
    assert {"open_2dj_de", "joint_3d_norm", "kp_cons", "hm_integral", "hm_integral_gt"} <= read
    photometric = ("texture", "mrgb", "ssim_tex", "texture_self", "mrgb_self", "ssim_tex_self")
    assert read <= set(PORTED_LOSSES) and set(photometric) <= set(PORTED_LOSSES)
    for field in ("losses", "losses_frei", "losses_rhd"):
        Config(**{field: photometric})
        Config(**{field: tuple(sorted(read))})
        with pytest.raises(NotImplementedError):
            Config(**{field: ("no_such_loss",)})
    Config(losses=PORTED_LOSSES)  # every ported name is accepted
