"""Every cell, configuration, traffic mix, metric and limits file of
BENCHMARK.json is found by name, and a new cell made of new files alone
runs through the same lookup."""

from __future__ import annotations

import json
import os
import shutil

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
