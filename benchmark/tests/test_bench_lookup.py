"""Every cell, configuration, traffic mix, metric and limits file of
BENCHMARK.json is found by name, and a new cell made of new files alone
(its own reference package and kernel file among them) runs through the
same lookup."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

from benchmark import loops, spec

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_found(cell):
    c = spec.find_cell(cell)
    assert c.chips == 1
    assert c.traffic["loop"] in loops.LOOPS
    assert spec.batch_size(c) >= 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer and c.limits
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_builds_the_ports_config(conf):
    from benchmark.reference.config import Config

    with open(os.path.join(spec.ROOT, conf["file"])) as f:
        fields = spec.port_config_dict(json.load(f))
    cfg = Config.from_dict(fields)
    assert cfg.image_size == 224 and cfg.aa_factor == 3 and cfg.aa_mode == "msaa"


def test_paper_config_is_the_shipped_file():
    with open(os.path.join(spec.ROOT, "configs", "FreiHAND", "full_rhd_freihand.json")) as f:
        shipped = json.load(f)
    mine = spec.find_cell("paper_nimble_effb3.train_b48").config
    assert {k: mine[k] for k in shipped} == shipped


def test_a_new_cell_from_new_files_alone(tmp_path):
    """A copy of the benchmark folder with one more configuration, mix,
    metric and limits file, and their entries in BENCHMARK.json."""
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests", "reference"))
    bench = json.loads(json.dumps(BENCH))
    conf = dict(spec.find_cell("flagship_mano_res50.train_b64").config, train_batch=16)
    (here / "configs" / "dummy.json").write_text(json.dumps(conf))
    (here / "traffic" / "dummy_pool.json").write_text(json.dumps(dict(spec.find_cell(
        "flagship_mano_res50.train_b64").traffic, pool_batches=2)))
    (here / "metrics" / "dummy_metric.py").write_text("def read(run):\n    return 42.0\n")
    (here / "limits" / "dummy.small.json").write_text(json.dumps({"loss_gap": 1.0}))
    bench["configs"].append({"name": "dummy", "source": "x", "file": "benchmark/configs/dummy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy.small", "config": "dummy", "traffic": "dummy_pool", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "setup_s", "workloads": ["dummy.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("dummy.small", here=str(here))
    assert spec.batch_size(cell) == 16 and cell.traffic["pool_batches"] == 2
    assert cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    assert spec.metric_reader("dummy_metric", here=str(here))({}) == 42.0


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.find_cell("no_such.cell")


def test_unknown_loop_raises():
    from bench_tiny import tiny_cell
    from benchmark import run as bench_run

    cell = tiny_cell("flagship_mano_res50.train_b64")
    cell.traffic["loop"] = "train_dp"
    with pytest.raises(ValueError, match="train_dp"):
        bench_run.run_cell(cell, 1, 0.1, False, "cpu")


PROBE_REFERENCE = '''"""A configuration's own reference: the default one, with a loss stack
that marks its use."""

from benchmark import reference
from benchmark.reference import *  # noqa: F401,F403

USED = []


class LossComputer(reference.LossComputer):
    def __init__(self, cfg, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        USED.append(type(self).__module__)
'''

PROBE_KERNEL = '''"""A kernel file of a new configuration: the renderer's face selection."""

WRAPS = ("hifihr_tpu_torch.render.renderer", "PhongRenderer.select_faces")
TRACE = (("probe_kernel", ()),)


def record(renderer, verts_cam, K):
    return tuple(verts_cam.shape)


def bound_s(call):
    return 1e-6
'''


def probe_benchmark(tmp_path, reference: str) -> str:
    """A copy of the benchmark folder, without its tests and reference,
    with one more configuration (naming `reference`), mix, limits file,
    reference package, kernel file and metric, and their entries in
    BENCHMARK.json; returns the folder."""
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests", "reference"))
    flagship = spec.find_cell("flagship_mano_res50.train_b64")
    (here / "configs" / "probe.json").write_text(json.dumps(dict(flagship.config, reference=reference)))
    (here / "traffic" / "probe_pool.json").write_text(json.dumps(flagship.traffic))
    (here / "limits" / "probe.tiny.json").write_text(json.dumps(flagship.limits))
    (here / "reference_probe").mkdir()
    (here / "reference_probe" / "__init__.py").write_text(PROBE_REFERENCE)
    (here / "kernels" / "k9.py").write_text(PROBE_KERNEL)
    # a metric named k9_roofline.<...> has the traced run wrap K9; this one reads its calls
    (here / "metrics" / "k9_roofline.calls.py").write_text('def read(run):\n    return len(run["calls"].get("K9", []))\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "probe", "source": "x", "file": "benchmark/configs/probe.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "probe.tiny", "config": "probe", "traffic": "probe_pool", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("probe.tiny")
    bench["per_layer"].append({"name": "k9_roofline.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "kernels", "moves": "train_images_per_s",
                               "workloads": ["probe.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(here)


@pytest.fixture
def probe_package(monkeypatch):
    """benchmark.<name> found in a copied folder too, as in a checkout
    that holds the new files; its modules dropped afterwards."""
    import benchmark

    def add(here):
        monkeypatch.setattr(benchmark, "__path__", [*benchmark.__path__, here])

    yield add
    for name in [n for n in sys.modules if n.startswith("benchmark.reference_probe")]:
        del sys.modules[name]


def test_a_configuration_brings_its_own_reference_and_kernel_file(tmp_path, probe_package):
    """A configuration that names its own reference package, with a kernel
    file and a metric of its own, is found and run (traced, at the tiny
    size) and judged by that reference from new files alone."""
    import time

    from bench_tiny import tiny_cell
    from benchmark import run as bench_run

    here = probe_benchmark(tmp_path, "benchmark.reference_probe")
    probe_package(here)
    cell = tiny_cell("probe.tiny", here=here)
    assert cell.reference == "benchmark.reference_probe" and cell.here == here
    assert "reference" not in spec.port_config_dict(cell.config)
    out = bench_run.run_cell(cell, 2**31 + 4242, 0.2, True, "cpu", t_start=time.perf_counter())
    used = sys.modules["benchmark.reference_probe"].USED
    assert used == ["benchmark.reference_probe"], used  # the check built its loss stack from the package
    assert out["correct"], out["checks"]
    assert out["metrics"]["k9_roofline.calls"]["value"] >= 1  # each window step renders once
    assert "k1_roofline.train" not in out["metrics"]  # no device trace on the CPU: nothing read
    from hifihr_tpu_torch.render import renderer

    assert "wrapped" not in renderer.PhongRenderer.select_faces.__qualname__  # unwrapped after the window


def test_an_unknown_reference_package_fails_at_lookup(tmp_path, probe_package):
    here = probe_benchmark(tmp_path, "benchmark.no_such_reference")
    probe_package(here)
    with pytest.raises(ValueError, match="no_such_reference"):
        spec.find_cell("probe.tiny", here=here)
    # a package of the program's, or one that lacks an entry point, is no reference either
    for name, why in (("hifihr_tpu_torch", "benchmark's own"), ("benchmark.spec", "lacks")):
        with pytest.raises(ValueError, match=why):
            spec.reference_api(name)
