"""Lookup by name: the cell, its configuration, its traffic mix, its metrics,
their readers and its correctness limits, all from BENCHMARK.json and the
files beside this module."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# keys of a configuration file that are the benchmark's, not the port's Config
BENCH_KEYS = ("source", "assumed", "dataset", "batch_keys")


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
    for a name the file does not have and FileNotFoundError for a missing
    file."""
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
    return Cell(
        name=name, config_name=os.path.splitext(os.path.basename(config_file))[0],
        config=_read_json(config_file),
        traffic=_read_json(os.path.join(here, "traffic", f"{traffic}.json")),
        chips=chips,
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
        limits=_read_json(os.path.join(here, "limits", f"{name}.json")),
    )


def port_config_dict(config_file: dict) -> dict:
    """The port's Config fields of a configuration file (its benchmark keys
    dropped)."""
    return {k: v for k, v in config_file.items() if k not in BENCH_KEYS}


def batch_size(cell: Cell) -> int:
    """The traffic's batch: a number, or the name of the configuration's
    key that holds it (train_batch, val_batch)."""
    b = cell.traffic["batch"]
    return int(cell.config[b]) if isinstance(b, str) else int(b)


def metric_reader(name: str, here: str = HERE):
    """metrics/<name>.py's `read(run) -> float | None`, loaded by path (a
    metric name may hold dots)."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
