"""The reference on its own: it imports nothing of the port, its binned face
selection is the plain one bit for bit, and at a tiny size on the CPU
(where the port runs its plain versions) it agrees with the port through a
whole run of each cell."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bench_tiny import tiny_cell
from benchmark import run as bench_run
from benchmark import spec


def reference_packages() -> list[str]:
    """The default reference and every package a configuration names."""
    named = set()
    for conf in spec.load_benchmark()["configs"]:
        with open(os.path.join(spec.ROOT, conf["file"])) as f:
            named.add(json.load(f).get("reference", spec.DEFAULT_REFERENCE))
    return sorted(named | {spec.DEFAULT_REFERENCE})


@pytest.mark.parametrize("package", reference_packages())
def test_reference_sources_import_no_port_and_no_jax(package):
    """Every source of the package imports neither the port nor JAX, and of
    the benchmark only reference packages."""
    bad = ("hifihr_tpu", "hifihr_tpu_torch", "jax", "jaxlib", "flax")
    refs = {p.split(".")[1] for p in reference_packages()}
    for dirpath, _, files in os.walk(importlib.util.find_spec(package).submodule_search_locations[0]):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        words = line.replace(",", " ").split()
                        if words[:1] not in (["import"], ["from"]) or len(words) < 2:
                            continue
                        top = words[1].split(".")
                        assert top[0] not in bad, (f, line)
                        if top[0] == "benchmark":
                            # benchmark.<x>..., or `from benchmark import <x>, ...`
                            parts = top[1:2] if len(top) > 1 else words[3:]
                            assert parts and all(p in refs for p in parts), (f, line)


def test_reference_loads_no_port_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference.models.hifihr import build_model\n"
            "from benchmark.reference.training.steps import make_train_step\n"
            "from benchmark.reference.losses.stack import LossComputer\n"
            "from benchmark.reference.config import Config\n"
            "m = build_model(Config(pretrain='res18', image_size=32, light_estimation=False), 'cpu')\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & {'hifihr_tpu_torch', 'hifihr_tpu', 'jax'}))"
            % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hifihr_tpu_torch_like", object())
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hifihr_tpu.config", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert bench_run.forbidden_modules() == ["hifihr_tpu", "jaxlib"]


@pytest.mark.parametrize("seed", [1, 2**31 + 12345])
def test_binned_selection_is_the_plain_one(seed):
    from benchmark.reference.render import raster_msaa as r
    from benchmark.scene import posed_hands

    gen = torch.Generator().manual_seed(seed)
    scene = dict(spec.find_cell("flagship_mano_res50.train_b64").traffic["scene"], focal_px=[40.0, 90.0])
    hands = posed_hands(3, 40, scene, gen, "cpu")
    from benchmark.reference.hand.mano import ManoLayer
    from benchmark.reference.render.raster import project_to_screen
    from benchmark.reference.render.renderer import PhongRenderer

    mano = ManoLayer(ncomps=45)
    faces = PhongRenderer(mano.faces_np, mano.v_template_np).faces
    coef, bbox = r.msaa_prep(project_to_screen(hands["verts"], hands["Ks"]), faces)
    plain = r.msaa_select_plain(coef, 40)
    binned = r.msaa_select_binned(coef, bbox, 40)
    assert (plain[0] >= 0).any()
    for a, b in zip(plain, binned):
        assert torch.equal(a, b)


def test_scene_is_a_function_of_the_seed():
    from benchmark.scene import posed_hands

    scene = spec.find_cell("flagship_mano_res50.train_b64").traffic["scene"]
    a = posed_hands(4, 32, scene, torch.Generator().manual_seed(5), "cpu")
    b = posed_hands(4, 32, scene, torch.Generator().manual_seed(5), "cpu")
    chunked = posed_hands(4, 32, scene, torch.Generator().manual_seed(5), "cpu", chunk=3)
    c = posed_hands(4, 32, scene, torch.Generator().manual_seed(6), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    # the same draws however the rows are cut (the posing's arithmetic may round apart)
    assert torch.allclose(a["joints"], chunked["joints"], atol=1e-6)
    assert not torch.equal(a["joints"], c["joints"])
    assert 0.0 < float(a["segms_gt"].mean()) < 1.0


CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_the_reference_at_a_tiny_size(name):
    cell = tiny_cell(name)
    out = bench_run.run_cell(cell, 2**31 + 77, 0.2, False, "cpu", t_start=time.perf_counter())
    assert out["attempted"] > 0 and out["failed"] == 0
    numbers = {k: v for k, v in out["_numbers"].items() if not k.startswith("_")}
    assert numbers and all(v <= 1e-5 for v in numbers.values()), numbers
    assert out["correct"]
    assert cell.end_to_end
    for m in cell.end_to_end:
        assert out["metrics"][m["name"]]["value"] > 0
