"""NIMBLE parametric hand layer (counterpart of hifihr_tpu/hand/nimble.py::
NimbleLayer): 20/30/10 shape/pose/texture PCA over a 5990-vertex,
11,926-face skin mesh with 25 joints.

`vert_uv` (V, 2) and `face_uv_np` (F, 3, 2) are the asset's UV chart and
per-corner atlas, where it has them.

`layer(hand_params)` -> {nimble_joints (B, 25, 3), verts and skin_verts
(B, 5990, 3), skin_albedo (B, 5990, 3), mano_verts (B, 778, 3), textures
(B, 256, 256, 7), joints (B, 21, 3) in the legacy MANO order, rot (B, 3)}.
Every product runs in fp32, as JAX's layer runs under
`default_matmul_precision("highest")`; on the card that needs TF32 off
(`training.steps.set_fp32_numerics`, which both steps call).

Init-time constants, as in JAX: the UV appearance maps (diffuse, tangent
space normal, spec weight; means and PCA bases) bilinearly upsampled to
tex_size^2 and concatenated into 7 channels, and the corner-sampled
appearance `corner_mean_np` (F, 3, 7) and `corner_basis_np` (F, 3, 7, T):
the same maps sampled at the per-face-corner atlas UVs, in float64 numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from benchmark.reference import constant
from benchmark.reference.assets import NimbleModel, load_nimble_model
from benchmark.reference.geometry.rotations import axis_angle_to_matrix
from benchmark.reference.hand.mano import _rigid_tf

# the legacy MANO-order 21 joints as rows of nimble_joints = [the 16 posed
# bones | the 9 regressed joints]: tips (25-joint ids 16-20: thumb, index,
# middle, ring, pinky) at slots 4, 8, 12, 16 and 20 of the index, middle,
# pinky, ring and thumb chains
_JOINTS21 = [0, 1, 2, 3, 17, 4, 5, 6, 18, 7, 8, 9, 20, 10, 11, 12, 19, 13, 14, 15, 16]


def _upsample(a: np.ndarray, size: int) -> torch.Tensor:
    """(h, w, ...) map -> (size, size, ...) fp32 by bilinear interpolation
    with half-pixel centres: jax.image.resize(..., "bilinear") when
    upsampling, to within an ulp (its weights are computed otherwise)."""
    a = torch.as_tensor(np.asarray(a, np.float32))
    h, w = a.shape[:2]
    rest = a.shape[2:]
    x = a.reshape(1, h, w, -1).permute(0, 3, 1, 2)
    x = Fn.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1).reshape((size, size) + rest).contiguous()


def _corner_sample(img: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Bilinear sample of a (h, w, C[, T]) map at (F, 3, 2) UVs in float64,
    the JAX layer's init-time `csamp`, as float32."""
    a = np.asarray(img, np.float64)
    h, w = a.shape[:2]
    x = np.clip(corners[..., 0], 0.0, 1.0) * (w - 1)
    y = np.clip(corners[..., 1], 0.0, 1.0) * (h - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    if a.ndim == 4:
        fx, fy = fx[..., None], fy[..., None]
    t00, t01 = a[y0, x0], a[y0, x0 + 1]
    t10, t11 = a[y0 + 1, x0], a[y0 + 1, x0 + 1]
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


class NimbleLayer(nn.Module):
    """The model tensors are non-persistent buffers: they follow
    `.to(device)` and stay out of the state dict."""

    def __init__(self, model: NimbleModel | None = None, shape_ncomp: int = 20,
                 pose_ncomp: int = 30, tex_ncomp: int = 10, tex_size: int = 256):
        super().__init__()
        m = model or load_nimble_model()
        self.shape_ncomp = shape_ncomp
        self.pose_ncomp = min(pose_ncomp, m.pose_basis.shape[0])
        self.tex_ncomp = tex_ncomp
        self.n_verts = m.v_template.shape[0]
        # host copies for the renderer's static face order and tables
        self.v_template_np = np.asarray(m.v_template, np.float32)
        self.faces_np = np.asarray(m.faces, np.int32)
        self.face_uv_np = None if m.face_uv is None else np.asarray(m.face_uv, np.float32)
        # the per-vertex UV chart (V, 2); the model renders through the UV
        # maps only where the asset has one (JAX hifihr.py:217-220)
        self.vert_uv_np = None if m.vert_uv is None else np.asarray(m.vert_uv, np.float32)
        parents = np.asarray(m.parents)
        # bones grouped by their depth in the chain, root excluded: each
        # level's transforms are one batched product with their parents'
        depth = [0] * len(parents)
        for j in range(1, len(parents)):
            depth[j] = depth[int(parents[j])] + 1
        self.levels = [[j for j in range(1, len(parents)) if depth[j] == d]
                       for d in range(1, max(depth) + 1)]
        self.parents = [int(p) for p in parents]

        def buf(name, a):
            t = a if a is None or torch.is_tensor(a) else torch.as_tensor(np.asarray(a, np.float32))
            self.register_buffer(name, t, persistent=False)

        buf("v_template", m.v_template)
        buf("shapedirs", np.asarray(m.shapedirs)[..., :shape_ncomp])
        buf("J_regressor", m.J_regressor)
        buf("lbs_weights", np.asarray(m.lbs_weights)[:, :16])
        buf("pose_basis", np.asarray(m.pose_basis)[:self.pose_ncomp])
        buf("hands_mean", m.hands_mean)
        buf("tex_mean", m.tex_mean)
        buf("tex_basis", np.asarray(m.tex_basis)[..., :tex_ncomp])
        self.register_buffer("mano_vertex_map", torch.as_tensor(np.asarray(m.mano_vertex_map), dtype=torch.int64),
                             persistent=False)
        buf("posedirs", None if m.posedirs is None else np.asarray(m.posedirs).reshape(self.n_verts * 3, 135))
        buf("vert_uv", m.vert_uv)

        # UV appearance maps at render resolution, channels [diffuse 3 |
        # normal 3 | spec 1] (diffuse only where the asset has no others)
        buf("tex_mean_uv", None)
        buf("tex_basis_uv", None)
        if m.tex_mean_uv is not None and m.tex_basis_uv is not None:
            t = tex_ncomp
            means = [_upsample(m.tex_mean_uv, tex_size)]
            bases = [_upsample(m.tex_basis_uv[..., :t], tex_size)]
            if m.normal_mean_uv is not None and m.spec_mean_uv is not None:
                means += [_upsample(m.normal_mean_uv, tex_size), _upsample(m.spec_mean_uv, tex_size)]
                bases += [_upsample(m.normal_basis_uv[..., :t], tex_size),
                          _upsample(m.spec_basis_uv[..., :t], tex_size)]
            self.tex_mean_uv = torch.cat(means, dim=-1)  # (h, w, 3|7)
            self.tex_basis_uv = torch.cat(bases, dim=-2)  # (h, w, 3|7, T)

        # corner-sampled appearance: the maps sampled at the F x 3 atlas
        # corner UVs, for the renderer's corner texture path
        self.corner_mean_np = self.corner_basis_np = None
        if m.face_uv is not None and m.tex_mean_uv is not None and m.tex_basis_uv is not None:
            corners = np.asarray(m.face_uv, np.float64)
            t = tex_ncomp
            cmeans = [_corner_sample(m.tex_mean_uv, corners)]
            cbases = [_corner_sample(m.tex_basis_uv[..., :t], corners)]
            if m.normal_mean_uv is not None and m.spec_mean_uv is not None:
                cmeans += [_corner_sample(m.normal_mean_uv, corners), _corner_sample(m.spec_mean_uv, corners)]
                cbases += [_corner_sample(m.normal_basis_uv[..., :t], corners),
                           _corner_sample(m.spec_basis_uv[..., :t], corners)]
            self.corner_mean_np = np.concatenate(cmeans, axis=-1)  # (F, 3, 3|7)
            self.corner_basis_np = np.concatenate(cbases, axis=-2)  # (F, 3, 3|7, T)

    def forward(self, hand_params: dict) -> dict:
        pose = hand_params["pose_params"]  # (B, 30)
        betas = hand_params["shape_params"]  # (B, 20)
        tex = hand_params.get("texture_params")  # (B, 10) or None
        rot = hand_params.get("rot")
        b = pose.shape[0]
        dev = pose.device

        hand_aa = self.hands_mean[None] + pose[:, :self.pose_ncomp] @ self.pose_basis
        root_aa = rot if rot is not None else pose.new_zeros((b, 3))
        rots = axis_angle_to_matrix(torch.cat([root_aa, hand_aa], dim=1).reshape(b, 16, 3))

        v_shaped = self.v_template[None] + torch.einsum(
            "vds,bs->bvd", self.shapedirs, betas[:, :self.shape_ncomp])
        joints25 = torch.einsum("jv,bvd->bjd", self.J_regressor, v_shaped)
        j16 = joints25[:, :16]

        # the kinematic chain, one batched product per level of the tree
        tfs = [None] * 16
        tfs[0] = _rigid_tf(rots[:, 0], j16[:, 0])[:, None]
        for level in self.levels:
            idx = constant(level, dev, torch.int64)
            par = constant([self.parents[j] for j in level], dev, torch.int64)
            parent_tf = torch.cat([tfs[self.parents[j]] for j in level], dim=1)
            local = _rigid_tf(rots.index_select(1, idx), j16.index_select(1, idx) - j16.index_select(1, par))
            out = parent_tf @ local
            for k, j in enumerate(level):
                tfs[j] = out[:, k:k + 1]
        A = torch.cat(tfs, dim=1)  # (B, 16, 4, 4)
        posed_j16 = A[:, :, :3, 3]
        inv_bind = torch.einsum("bjxy,bjy->bjx", A[:, :, :3, :3], j16)
        A = torch.cat([A[:, :, :3, :3], (A[:, :, :3, 3] - inv_bind)[..., None]], dim=-1)  # (B, 16, 3, 4)

        T = torch.einsum("vj,bjxy->bvxy", self.lbs_weights, A)  # (B, V, 3, 4)
        v_posed = v_shaped
        if self.posedirs is not None:  # pose correctives
            eye = torch.eye(3, dtype=rots.dtype, device=dev)
            pose_map = (rots[:, 1:] - eye).reshape(b, 135)
            v_posed = v_posed + (pose_map @ self.posedirs.T).reshape(b, self.n_verts, 3)
        skin_verts = torch.einsum("bvxy,bvy->bvx", T[..., :3], v_posed) + T[..., 3]

        # the skinning bones move rigidly; tip and palm joints are regressed
        # from the posed skin
        derived = torch.einsum("jv,bvd->bjd", self.J_regressor[16:], skin_verts)
        nimble_joints = torch.cat([posed_j16, derived], dim=1)
        joints21 = nimble_joints.index_select(1, constant(_JOINTS21, dev, torch.int64))

        albedo = self.tex_mean[None]
        if tex is not None:
            albedo = albedo + torch.einsum("vdt,bt->bvd", self.tex_basis, tex[:, :self.tex_ncomp])
        albedo = albedo.clamp(0.0, 1.0).expand(b, -1, -1)

        textures = albedo
        if self.tex_mean_uv is not None:
            textures = self.tex_mean_uv[None].expand((b,) + self.tex_mean_uv.shape)
            if tex is not None:
                textures = textures + torch.einsum("hwct,bt->bhwc", self.tex_basis_uv, tex[:, :self.tex_ncomp])
            textures = textures.clamp(0.0, 1.0)

        return {
            "nimble_joints": nimble_joints,
            "verts": skin_verts,
            "skin_verts": skin_verts,
            "skin_albedo": albedo,
            "mano_verts": skin_verts.index_select(1, self.mano_vertex_map),
            "textures": textures,
            "joints": joints21,
            "rot": root_aa,
        }
