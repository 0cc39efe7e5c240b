"""K6's arithmetic (render/ssaa_shade.py) on the CPU, with no JAX.

`ssaa_shade_partials_plain`, the plain version of K6's forward and its
hand-derived backward, against autograd through the composed SSAA shade
(`PhongRenderer._shade_plain`: barycentric_coords, the interpolations,
sample_texture, phong_shade, the pool) in float64, for each plan K6 takes:
NIMBLE-like UV maps with the normal and spec maps on a per-face atlas, the
same without the maps, vertex colours with a light that requires grad, and
a per-vertex chart. The scene: a bumpy sheet of 288 faces and a sliver face
in front of it, in three images at 48^2 (144^2 supersampled): one in view,
one past the image's right edge, one with nothing on it. And the checks
that make K6's wrapper raise on what the kernel does not take, without a
card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

SIZE, AA, N = 48, 3, 13  # base image, supersampling, grid vertices a side
PLANS = {"atlas_maps": ("atlas", True), "atlas": ("atlas", False), "colors_light_grad": ("colors", False),
         "chart": ("chart", False)}


def _mesh():
    """(verts (V, 3) in camera space about z = 0.5, faces (F, 3), the grid's
    per-vertex UV (V, 2), a per-face atlas (F, 3, 2)): a bumpy N x N sheet,
    and a sliver (three nearly collinear vertices) in front of it."""
    rng = np.random.RandomState(3)
    g = np.linspace(-0.1, 0.1, N)
    x, y = np.meshgrid(g, g)
    z = 0.5 + 0.02 * np.sin(40 * x) * np.cos(30 * y)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    uv = np.stack(np.meshgrid(np.linspace(0, 1, N), np.linspace(0, 1, N)), -1).reshape(-1, 2)
    idx = np.arange(N * N).reshape(N, N)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])
    sliver = np.asarray([[-0.05, 0.0095, 0.45], [0.05, 0.00952, 0.45], [0.0, 0.00956, 0.4501]])
    verts = np.concatenate([verts, sliver])
    uv = np.concatenate([uv, [[0.2, 0.2], [0.8, 0.2], [0.5, 0.21]]])
    faces = np.concatenate([faces, [[N * N, N * N + 1, N * N + 2]]])
    atlas = np.clip(uv[faces] + 0.03 * rng.randn(len(faces), 3, 2), 0.0, 1.0)
    return verts, faces, uv, atlas


@pytest.fixture(scope="module")
def scene():
    from hifihr_tpu_torch.render.raster import project_to_screen, rasterize_face_id
    from hifihr_tpu_torch.render.renderer import _scale_intrinsics

    verts, faces, uv, atlas = _mesh()
    shift = torch.tensor([[0.0, 0.0, 0.0], [0.12, 0.03, 0.0], [1.0, 0.0, 0.0]], dtype=torch.float64)
    verts_cam = torch.as_tensor(verts)[None] + shift[:, None]
    f = SIZE * 1.8
    K = torch.tensor([[f, 0, SIZE / 2], [0, f, SIZE / 2], [0, 0, 1]], dtype=torch.float64).repeat(3, 1, 1)
    screen = project_to_screen(verts_cam, _scale_intrinsics(K, float(AA)))
    faces_t = torch.as_tensor(faces, dtype=torch.int64)
    face_id, _ = rasterize_face_id(screen.float(), faces_t, SIZE * AA)
    covered = (face_id >= 0).float().mean(dim=(1, 2))
    assert 0.1 < covered[0] < 0.9 and 0.02 < covered[1] < covered[0] and covered[2] == 0
    assert bool((face_id == len(faces) - 1).any())  # the sliver is seen
    return {"verts_cam": verts_cam, "screen": screen, "faces": faces_t, "uv": uv, "atlas": atlas,
            "face_id": face_id}


def _inputs(scene, kind: str, with_maps: bool):
    """The renderer of the plan, its float64 leaves (screen, channels, maps,
    light fields) and the output's gradient."""
    from hifihr_tpu_torch.render.renderer import PhongRenderer, RenderSettings
    from hifihr_tpu_torch.render.shading import DirectionalLight

    gen = torch.Generator().manual_seed(11)
    B, V = scene["screen"].shape[:2]
    settings = RenderSettings(image_size=SIZE, aa_factor=AA, aa_mode="ssaa")
    renderer = PhongRenderer(scene["faces"].numpy(), settings=settings,
                             face_uv=scene["atlas"] if kind == "atlas" else None,
                             vert_uv=scene["uv"] if kind == "chart" else None)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float64)

    texture = rand(B, 16, 12, 7 if with_maps else 3) if kind != "colors" else None
    plan = renderer._plan(rand(B, V, 3), texture)
    assert (plan.use_uv, plan.with_maps, plan.uv_in_verts) == (kind != "colors", with_maps, kind == "chart")
    parts = []
    if kind == "colors":
        parts.append(rand(B, V, 3))
    elif kind == "chart":
        parts.append(renderer.vert_uv[None].expand(B, V, 2).double())
    if with_maps:
        parts.append(rand(B, V, 3) - 0.5)  # tangents
    normals = rand(B, V, 3) - 0.5
    normals[..., 2] -= 1.0  # mostly facing the camera
    parts += [normals, scene["verts_cam"]]
    direction = torch.tensor([0.3, -0.2, -1.0], dtype=torch.float64) + 0.2 * rand(B, 3)
    leaves = {"screen": scene["screen"].clone(), "attrs": torch.cat(parts, -1), "texture": texture,
              "ambient": rand(B, 3), "diffuse": rand(B, 3), "specular": rand(B, 3), "direction": direction}
    for k, t in leaves.items():
        if t is not None and (k in ("screen", "attrs", "texture") or kind == "colors"):
            t.requires_grad_(True)
    light = DirectionalLight(leaves["ambient"], leaves["diffuse"], leaves["specular"], leaves["direction"])
    grad = rand(B, SIZE, SIZE, 5) - 0.5
    return renderer, plan, leaves, light, grad


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_ssaa_shade_partials_plain_matches_autograd(scene, plan_name):
    from hifihr_tpu_torch.render.ssaa_shade import LAYOUTS, light_vector, shade_table, ssaa_shade_partials_plain

    kind, with_maps = PLANS[plan_name]
    renderer, plan, leaves, light, grad = _inputs(scene, kind, with_maps)
    out = renderer._shade_plain(plan, scene["face_id"], leaves["screen"], leaves["attrs"], light, leaves["texture"])
    wanted = {k: t for k, t in leaves.items() if t is not None and t.requires_grad}
    ref = dict(zip(wanted, torch.autograd.grad(out, list(wanted.values()), grad)))

    lvec = light_vector(light)
    table = shade_table(leaves["screen"], leaves["attrs"], LAYOUTS[kind, with_maps].width)
    texture = None if leaves["texture"] is None else leaves["texture"].detach()
    got_out, d_table, d_tex, d_light = ssaa_shade_partials_plain(
        scene["face_id"], table.detach(), renderer.faces, renderer.face_uv, texture, lvec.detach(), AA, kind,
        with_maps, grad)
    out = out.detach()
    torch.testing.assert_close(got_out, out, rtol=0, atol=1e-12)
    assert float(out[2].abs().max()) == 0.0 and float(out[0, ..., 3].max()) > 0.5  # the empty image, a covered one
    D = leaves["attrs"].shape[-1]
    got = {"screen": d_table[..., :3], "attrs": d_table[..., 3:3 + D], "texture": d_tex}
    if kind == "colors":
        got.update(zip(("ambient", "diffuse", "specular", "direction"),
                       torch.autograd.grad(lvec, [leaves[k] for k in ("ambient", "diffuse", "specular", "direction")],
                                           d_light)))
    assert float(d_table[..., 3 + D:].abs().sum()) == 0.0  # the pad
    for name, r in ref.items():
        assert float(r.norm()) > 0, name
        err = float((got[name] - r).norm() / r.norm())
        assert err < 1e-10, (name, err)


@pytest.mark.parametrize("case", ["dtype", "face_id_dtype", "non_contiguous", "channels", "maps_width", "aa",
                                  "no_atlas", "cpu"])
def test_ssaa_shade_raises_on_what_k6_does_not_take(case):
    from hifihr_tpu_torch.render.shading import DirectionalLight
    from hifihr_tpu_torch.render.ssaa_shade import ssaa_shade

    B, V, F, S = 2, 10, 4, 12
    args = {"face_id": torch.full((B, S, S), -1, dtype=torch.int32), "verts_screen": torch.rand(B, V, 3),
            "attrs": torch.rand(B, V, 9), "faces": torch.randint(0, V, (F, 3)),
            "light": DirectionalLight.default(B), "aa": 3, "kind": "atlas", "with_maps": True,
            "face_uv": torch.rand(F, 3, 2), "texture": torch.rand(B, 8, 8, 7)}
    exc = ValueError
    if case == "dtype":
        args["attrs"], exc = args["attrs"].double(), TypeError
    elif case == "face_id_dtype":
        args["face_id"], exc = args["face_id"].long(), TypeError
    elif case == "non_contiguous":
        args["texture"] = torch.rand(B, 8, 7, 8).transpose(2, 3)
    elif case == "channels":
        args["attrs"] = torch.rand(B, V, 6)  # the atlas plan with maps takes tangents, normals, points
    elif case == "maps_width":
        args["texture"] = torch.rand(B, 8, 8, 3)  # the maps need 7 channels
    elif case == "aa":
        args["aa"] = 5
    elif case == "no_atlas":
        args["face_uv"] = None
    with pytest.raises(exc):
        ssaa_shade(**args)
