"""Test-time MANO fitting (counterpart of hifihr_tpu/training/fitting.py,
the reference's mano_fitting, utils/traineval_util.py:505-596).

From the network's MANO parameters, N_STEPS Adam steps over pose, betas,
trans and scale minimise 1e-3 x the 2D reprojection error to the target
keypoints + 0.1 x the bone-direction loss + 0.1 x the tilt-swing-azimuth
pose prior + 1e-3 x mean(betas^2) + 1e-2 x mean((|scale| - 1)^2). The
learning rate is 0.01, halved when the update count reaches 50 and again at
100 (optax's piecewise_constant_schedule: the update with count 50, the
51st, already takes 0.005); Adam has optax's constants and formula.

The JAX package runs the fit as one jitted `fori_loop`; here it runs
eagerly, one autograd step after another, with every learning rate and bias
correction a host number, so the loop makes the host wait for the card
nowhere.
"""

from __future__ import annotations

import numpy as np
import torch

from hifihr_tpu_torch import resolve_device
from hifihr_tpu_torch.geometry.projection import perspective_project
from hifihr_tpu_torch.hand.mano import ManoLayer, regress_joints_frei
from hifihr_tpu_torch.losses.basic import bone_direction_loss, tsa_pose_loss
from hifihr_tpu_torch.training.train_state import B1, B2, EPS

N_STEPS = 151
LR = 0.01
LR_HALVED_AT = (50, 100)
PARAMS = ("pose", "betas", "trans", "scale")


def learning_rate(count: int) -> float:
    """The rate of the update with count `count` (0 for the first), in
    float32 as optax computes it."""
    lr = np.float32(LR)
    for boundary in LR_HALVED_AT:
        if count >= boundary:
            lr = np.float32(0.5) * lr
    return float(lr)


def fitting_loss(mano: ManoLayer, p: dict, Ks: torch.Tensor, target_2d: torch.Tensor,
                 target_conf: torch.Tensor, root_xyz: torch.Tensor) -> torch.Tensor:
    """The fit's objective on parameters p (pose (B, 48), betas (B, 10),
    trans (B, 3), scale (B, 1)), Ks (B, 3, 3), target_2d (B, 21, 2),
    target_conf (B, 21, 1), root_xyz (B, 1, 3)."""
    out = mano(p["pose"], p["betas"])
    joints = regress_joints_frei(out.verts, mano.J_regressor)
    joints = joints - joints[:, 9:10]
    j3d = joints * p["scale"].abs()[:, None, :] + root_xyz + p["trans"][:, None, :]
    j2d = perspective_project(j3d, Ks)
    reproj = (((j2d - target_2d) ** 2).sum(-1) * target_conf[..., 0]).mean()
    bone = bone_direction_loss(j2d, target_2d, target_conf)
    pose_prior = tsa_pose_loss(out.full_pose)
    shape_prior = (p["betas"] ** 2).mean()
    scale_prior = ((p["scale"].abs() - 1.0) ** 2).mean()
    return 1e-3 * reproj + 0.1 * bone + 0.1 * pose_prior + 1e-3 * shape_prior + 1e-2 * scale_prior


def make_fitting_fn(mano: ManoLayer, n_steps: int = N_STEPS, device=None):
    """Returns fit(pose, betas, trans, scale, Ks, target_2d, target_conf,
    root_xyz) -> {'pose', 'betas', 'trans', 'scale'}, the refined
    parameters, on `device` (CUDA unless the caller passes 'cpu'), where
    `mano` is moved and the inputs must lie. Gradients are enabled inside
    the fit, so it runs under torch.no_grad() too; inputs made under
    inference_mode are copied out of it."""
    dev = resolve_device(device)
    mano = mano.to(dev)

    def fit(pose, betas, trans, scale, Ks, target_2d, target_conf, root_xyz) -> dict:
        with torch.inference_mode(False), torch.enable_grad():
            p = {k: v.detach().clone().float().requires_grad_()
                 for k, v in zip(PARAMS, (pose, betas, trans, scale))}
            Ks, target_2d, target_conf, root_xyz = (x.clone() for x in (Ks, target_2d, target_conf, root_xyz))
            params = list(p.values())
            mu = [torch.zeros_like(v) for v in params]
            nu = [torch.zeros_like(v) for v in params]
            for count in range(n_steps):
                grads = torch.autograd.grad(fitting_loss(mano, p, Ks, target_2d, target_conf, root_xyz), params)
                lr, t = learning_rate(count), count + 1
                with torch.no_grad():
                    # optax.adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
                    # p -= lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps); one
                    # multi-tensor launch per operation over the four parameters
                    torch._foreach_mul_(mu, B1)
                    torch._foreach_add_(mu, grads, alpha=1.0 - B1)
                    torch._foreach_mul_(nu, B2)
                    torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1.0 - B2)
                    den = torch._foreach_div(nu, 1.0 - B2 ** t)
                    torch._foreach_sqrt_(den)
                    torch._foreach_add_(den, EPS)
                    step = torch._foreach_div(mu, 1.0 - B1 ** t)
                    torch._foreach_div_(step, den)
                    torch._foreach_mul_(step, lr)
                    torch._foreach_sub_(params, step)
            return {k: v.detach() for k, v in p.items()}

    return fit
