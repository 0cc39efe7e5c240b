"""The port's SSAA render against the benchmark's plain reference for it
(`benchmark.reference_ssaa`, which imports nothing of the port), on the CPU,
with no JAX: the upstream's textured FreiHAND configuration
(benchmark/configs/texture_nimble_res101_ssaa.json: NIMBLE, ResNet-101, the
SSAA render sampling NIMBLE's UV maps per fragment, its 11 losses, Adam) at
32 px (96^2 supersampled) and batch 2, with the port's seeded random weights
loaded into both, on the benchmark's seeded scene (its focal cut to the
image, as benchmark/tests/bench_tiny.py cuts it).

- K4's rule: the port's plain selection against the reference's binned one,
  bit for bit, on posed NIMBLE hands.
- The render, forward and the gradients of an L1 photometric loss to the
  vertices and the UV maps.
- The first train step: each loss term, the total, each leaf's gradient and
  Adam's update, by benchmark/check.py's numbers.
- The spans and counters of the SSAA render (utils/profiling.py).

Tolerances. On the CPU both sides run the same fp32 operations in the same
order, but for the backward of the per-fragment gathers (the port's plain
K3 is an `index_add_` into a flattened table, the reference's autograd's
scatter-add of `torch.gather`): sums of the same values in another order,
a few ulp apart where their orders differ (measured here: the render and
its gradients bit-equal; the train step's term_gap, loss_gap and
update_gap_median 0, grad_gap 2.8e-8). So the render is held at 1e-5
absolute on values in [0, 1] and its gradients at 1e-4 relative L2, and the
train step at the limit the benchmark's tiny-size test holds every cell to:
1e-5 on each of term_gap, loss_gap, grad_gap and update_gap_median. The
encoder in bf16 (the configuration's stated precision on the card) reads
term_gap 0.16 and grad_gap 0.80 against the fp32 reference (its rounding is
2^-8), far over those limits: `test_bf16_encoder_breaks_the_limits` checks
that they can tell.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILE = os.path.join(ROOT, "benchmark", "configs", "texture_nimble_res101_ssaa.json")
SIZE, BATCH, SEED = 32, 2, 2**31 + 19
LIMIT = 1e-5  # the train step's four numbers (module docstring)


def _fields(**over) -> dict:
    from benchmark import spec

    with open(CONFIG_FILE) as f:
        fields = spec.port_config_dict(json.load(f))
    return dict(fields, **{"image_size": SIZE, "train_batch": BATCH, "compute_dtype": "float32", **over})


@pytest.fixture(scope="module")
def pool():
    from benchmark.scene import posed_hands, split_batches

    with open(os.path.join(ROOT, "benchmark", "traffic", "train_pool.json")) as f:
        scene = dict(json.load(f)["scene"], focal_px=[60.0, 70.0])
    with open(CONFIG_FILE) as f:
        keys = tuple(json.load(f)["batch_keys"])
    hands = posed_hands(2 * BATCH, SIZE, scene, torch.Generator().manual_seed(SEED), "cpu")
    return split_batches(hands, BATCH, keys)


@pytest.fixture(scope="module")
def models():
    """(the port's model with its seeded weights, the reference's with the
    same state dict, that state dict)."""
    import benchmark.reference_ssaa as ref
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.models.hifihr import build_model

    port = build_model(Config.from_dict(_fields()), device="cpu", seed=SEED % 2**31)
    state = {k: v.clone() for k, v in port.state_dict().items()}
    reference = ref.build_model(ref.Config.from_dict(_fields()), "cpu")
    reference.load_state_dict(state, strict=True)
    return port, reference, state


@pytest.fixture(scope="module")
def posed(models, pool):
    """Posed NIMBLE hands before the scene's cameras: (render vertices,
    albedo, K, tex_coef, the UV maps)."""
    port = models[0]
    gen = torch.Generator().manual_seed(7)
    params = {"pose_params": torch.randn(BATCH, 30, generator=gen) * 1.5,
              "shape_params": torch.randn(BATCH, 20, generator=gen) * 0.5,
              "texture_params": torch.randn(BATCH, 10, generator=gen),
              "rot": torch.randn(BATCH, 3, generator=gen) * 0.6}
    with torch.no_grad():
        out = port.nimble(params)
    root = out["nimble_joints"][:, 11:12]
    verts = out["skin_verts"] - root + pool[0]["root_xyz"]
    return verts, out["skin_albedo"], pool[0]["Ks"][:, :3, :3], params["texture_params"], out["textures"]


def test_k4_rule_is_the_references_binned_selection(models, posed):
    from benchmark.reference_ssaa import raster as ref_raster
    from hifihr_tpu_torch.render.raster import face_triangles, select_face_id_plain
    from hifihr_tpu_torch.render.renderer import _scale_intrinsics, project_to_screen

    port = models[0]
    verts, _, K = posed[:3]
    S = SIZE * 3
    tri = face_triangles(project_to_screen(verts, _scale_intrinsics(K, 3.0)), port.renderer.faces)
    assert tri.shape == (BATCH, 11926, 9)
    fid, zb = select_face_id_plain(tri, S)
    ref_fid, ref_zb = ref_raster.select_face_id_binned(tri, S)
    assert 0.05 < float((fid >= 0).float().mean()) < 0.95
    assert torch.equal(fid, ref_fid)
    assert torch.equal(zb, ref_zb)


@pytest.fixture(scope="module")
def renders(models, posed):
    """Each side's render of the posed hands with the gradients of an L1
    photometric loss to the vertices and the UV maps, and the counters'
    change over the port's render and over a render without grad."""
    from hifihr_tpu_torch.utils import profiling

    port, reference, _ = models
    verts, albedo, K, tex_coef, textures = posed
    target = torch.rand(BATCH, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(8))
    out = {}
    for name, model in (("port", port), ("reference", reference)):
        v = verts.clone().requires_grad_(True)
        t = textures.clone().requires_grad_(True)
        before = dict(profiling.counters)
        rgba = model.renderer(v, albedo, K, tex_coef=tex_coef, texture_image=t)
        (rgba[..., :3] - target).abs().mean().backward()
        out[name] = (rgba.detach(), v.grad, t.grad, {k: profiling.counters[k] - before[k] for k in before})
    before = dict(profiling.counters)
    with torch.no_grad():
        port.renderer(verts, albedo, K, tex_coef=tex_coef, texture_image=textures)
    out["eval_counts"] = {k: profiling.counters[k] - before[k] for k in before}
    return out


def test_ssaa_render_forward(renders):
    rgba, ref = renders["port"][0], renders["reference"][0]
    assert rgba.shape == (BATCH, SIZE, SIZE, 5)
    assert 0.05 < float((rgba[..., 3] > 0).float().mean()) < 0.95
    assert float(rgba[..., :3].abs().max()) > 0.1
    torch.testing.assert_close(rgba, ref, rtol=0, atol=LIMIT)


@pytest.mark.parametrize("i, name", [(1, "verts"), (2, "texture_image")])
def test_ssaa_render_gradients(renders, i, name):
    g, ref = renders["port"][i], renders["reference"][i]
    assert float(ref.norm()) > 0, name
    assert float((g - ref).norm() / ref.norm()) < 1e-4, name


def test_ssaa_render_counters(renders):
    """With grad on, the shade pass runs twice (the forward and checkpoint's
    recompute in backward), each sampling the texture once; without, once."""
    counts = renders["port"][3]
    assert counts["sample_texture.launches"] == 2 and counts["ssaa_shade.recomputes"] == 1
    assert renders["eval_counts"]["sample_texture.launches"] == 1
    assert renders["eval_counts"]["ssaa_shade.recomputes"] == 0
    assert renders["reference"][3]["sample_texture.launches"] == 0  # the reference counts nothing


def _first_step(model, fields: dict, side, batch: dict, spans: bool = False) -> dict:
    """One train step of `side` (the port's modules or the reference
    package) from `model`'s weights: the record benchmark/check.py's
    train_numbers compares, with the spans and the counters' change."""
    import contextlib

    from hifihr_tpu_torch.utils import profiling

    cfg = side.Config.from_dict(fields)
    state = side.create_train_state(model, cfg)
    step = side.make_train_step(model, side.LossComputer(cfg), "FreiHand", cfg)
    sched = side.make_sched(cfg, 0, "cpu")
    opt = state.optimizer
    flat0 = opt.flat.clone()
    before = dict(profiling.counters)
    with profiling.spans() if spans else contextlib.nullcontext([]) as rec:
        _, losses = step(state, batch, sched)
    leaves, off = [], 0
    for p in opt.params:
        leaves.append((off, p.numel()))
        off += p.numel()
    terms = {k: float(v) for k, v in losses.items() if k not in ("total", "skipped")}
    return {"flat0": flat0, "flat3": opt.flat.clone(), "totals": losses["total"].reshape(1).detach(),
            "terms1": terms, "mu1": opt.mu.clone(), "g1": opt.grad.clone(), "leaves": leaves,
            "skipped": float(losses["skipped"]),
            "names": [n for n, p in model.named_parameters() if p.requires_grad], "spans": list(rec),
            "counts": {k: profiling.counters[k] - before[k] for k in before}}


@pytest.fixture(scope="module")
def steps(models, pool):
    """The first train step of the port (spans on), of the reference, and of
    the port with its encoder in bf16, all from the same weights."""
    from types import SimpleNamespace

    import benchmark.reference_ssaa as ref
    from hifihr_tpu_torch.config import Config
    from hifihr_tpu_torch.losses.stack import LossComputer
    from hifihr_tpu_torch.models.hifihr import HiFiHR
    from hifihr_tpu_torch.training.steps import make_sched, make_train_step
    from hifihr_tpu_torch.training.train_state import create_train_state

    Port = SimpleNamespace(Config=Config, LossComputer=LossComputer, create_train_state=create_train_state,
                           make_train_step=make_train_step, make_sched=make_sched)

    port, reference, state = models
    batch = pool[1]
    out = {"port": _first_step(port, _fields(), Port, batch, spans=True),
           "reference": _first_step(reference, _fields(), ref, batch)}
    bf16 = HiFiHR(Port.Config.from_dict(_fields(compute_dtype="bfloat16"))).to(memory_format=torch.channels_last)
    bf16.load_state_dict(state, strict=True)
    out["bf16"] = _first_step(bf16, _fields(compute_dtype="bfloat16"), Port, batch)
    return out


def _numbers(prog: dict, ref: dict) -> dict:
    from benchmark import check

    return {k: v for k, v in check.train_numbers(prog, ref).items() if not k.startswith("_")}


def test_first_train_step_against_the_reference(steps):
    port, ref = steps["port"], steps["reference"]
    assert port["skipped"] == ref["skipped"] == 0.0
    assert set(port["terms1"]) == set(ref["terms1"]) == {
        "joint_3d", "vert_3d", "bone_direc", "edge_length", "texture", "mrgb", "ssim_tex", "sil", "mshape",
        "mpose", "mtex"}
    assert all(v > 0 for v in ref["terms1"].values())
    numbers = _numbers(port, ref)
    assert numbers.keys() == {"loss_gap", "term_gap", "grad_gap", "update_gap_median"}
    assert all(v <= LIMIT for v in numbers.values()), numbers


def test_bf16_encoder_breaks_the_limits(steps):
    numbers = _numbers(steps["bf16"], steps["reference"])
    assert max(numbers.values()) > 10 * LIMIT, numbers


def test_train_step_spans_and_counters(steps):
    """The SSAA render's spans in a train step, each with its place in the
    tree (the shade's recompute inside its backward span), and the counters'
    change: one K4 selection, the texture sampled by the shade and by its
    recompute."""
    rec = steps["port"]["spans"]

    def path(s):
        names = []
        while s.parent is not None:
            s = rec[s.parent]
            names.append(s.name)
        return "/".join(reversed(names))

    got = [(s.name, path(s)) for s in rec if s.name.startswith("renderer")]
    assert got == [
        ("renderer", "step"), ("renderer.raster", "step/renderer"), ("renderer.shade", "step/renderer"),
        ("renderer.texture", "step/renderer/renderer.shade"), ("renderer.bwd", "step/backward"),
        ("renderer.shade.bwd", "step/backward/renderer.bwd"),
        ("renderer.shade.recompute", "step/backward/renderer.bwd/renderer.shade.bwd"),
        ("renderer.texture", "step/backward/renderer.bwd/renderer.shade.bwd/renderer.shade.recompute"),
        ("renderer.texture.bwd", "step/backward/renderer.bwd/renderer.shade.bwd")]
    counts = steps["port"]["counts"]
    assert counts["sample_texture.launches"] == 2 and counts["ssaa_shade.recomputes"] == 1
    assert steps["reference"]["counts"]["sample_texture.launches"] == 0
    np.testing.assert_array_equal([counts["rasterize_face_id.launches"], counts["gather_rows.launches"]], [0, 0])
