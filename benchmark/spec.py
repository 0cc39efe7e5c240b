"""Lookup by name: the cell, its configuration, its traffic mix, its metrics,
their readers, its correctness limits and its configuration's reference
package, all from BENCHMARK.json and the files beside this module."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# keys of a configuration file that are the benchmark's, not the port's Config
BENCH_KEYS = ("source", "assumed", "dataset", "batch_keys", "reference")
# the plain reference a configuration is checked against where its file
# names none under "reference"
DEFAULT_REFERENCE = "benchmark.reference"
# what the check takes from a reference package, by these names
REFERENCE_ENTRY_POINTS = ("Config", "build_model", "LossComputer", "make_train_step", "make_sched",
                          "create_train_state")


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict  # the configuration file as written
    traffic: dict  # the traffic file as written
    chips: int
    end_to_end: list  # BENCHMARK.json entries of the metrics this cell reports untraced
    per_layer: list  # and traced
    limits: dict  # limits/<cell>.json
    reference: str = DEFAULT_REFERENCE  # the configuration's reference package
    here: str = HERE  # the benchmark folder whose files make the cell


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict | None = None, here: str = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json with its files; raises KeyError
    for a name the file does not have, FileNotFoundError for a missing file
    and ValueError for a reference package that cannot serve."""
    bench = bench if bench is not None else load_benchmark(os.path.dirname(here))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return make_cell(name, os.path.join(os.path.dirname(here), conf["file"]), w["traffic"], int(w["chips"]),
                     bench, here)


def make_cell(name: str, config_file: str, traffic: str, chips: int, bench: dict, here: str = HERE) -> Cell:
    """A cell from its files: the configuration file's path, the traffic
    mix's name, limits/<name>.json, and the metrics of `bench` it reports."""
    config = _read_json(config_file)
    reference = config.get("reference", DEFAULT_REFERENCE)
    reference_api(reference)
    return Cell(
        name=name, config_name=os.path.splitext(os.path.basename(config_file))[0],
        config=config,
        traffic=_read_json(os.path.join(here, "traffic", f"{traffic}.json")),
        chips=chips,
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
        limits=_read_json(os.path.join(here, "limits", f"{name}.json")),
        reference=reference,
        here=here,
    )


def reference_api(package: str):
    """The reference package `package` (a package of the benchmark's own:
    `benchmark.reference`, or a new one beside it that may import its
    unchanged parts), imported, with every name of REFERENCE_ENTRY_POINTS.
    Raises ValueError for a package outside the benchmark, one that is not
    there, or one that lacks an entry point."""
    if package.split(".")[0] != "benchmark" or package == "benchmark":
        raise ValueError(f"reference package {package!r}: a reference is a package of the benchmark's own, "
                         f"benchmark.<name>")
    try:
        found = importlib.util.find_spec(package)
    except ModuleNotFoundError:  # a parent package is not there
        found = None
    if found is None:
        raise ValueError(f"reference package {package!r} not found")
    module = importlib.import_module(package)
    missing = [n for n in REFERENCE_ENTRY_POINTS if not hasattr(module, n)]
    if missing:
        raise ValueError(f"reference package {package!r} lacks {missing}")
    return module


def port_config_dict(config_file: dict) -> dict:
    """The port's Config fields of a configuration file (its benchmark keys
    dropped)."""
    return {k: v for k, v in config_file.items() if k not in BENCH_KEYS}


def batch_size(cell: Cell) -> int:
    """The traffic's batch: a number, or the name of the configuration's
    key that holds it (train_batch, val_batch)."""
    b = cell.traffic["batch"]
    return int(cell.config[b]) if isinstance(b, str) else int(b)


def load_file(path: str):
    """The module in the file `path`, loaded by path (a metric's name may
    hold dots)."""
    name = "benchmark_file_" + "".join(c if c.isalnum() else "_" for c in os.path.relpath(path, ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_module(name: str, here: str = HERE):
    """metrics/<name>.py, which holds the metric's `read(run) -> float | None`."""
    return load_file(os.path.join(here, "metrics", f"{name}.py"))


def metric_reader(name: str, here: str = HERE):
    """metrics/<name>.py's `read(run) -> float | None`."""
    return metric_module(name, here).read
