"""Finding a cell's parts by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one its `configs` entry names. The traffic
mix is benchmark/traffic/<traffic>.json, whose `driver` names the module
benchmark/drivers/<driver>.py that runs it. The limits of the compared
numbers are benchmark/limits/<cell>.json. A per-layer metric is read by
benchmark/metrics/<metric>.py, a module with read(trace) that returns a
number, or None when it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object
    limits: dict
    end_to_end: list
    per_layer: list


def _load(path):
    with open(path) as f:
        return json.load(f)


def reader(bench_dir: str, metric: str):
    """The read() of benchmark/metrics/<metric>.py."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str, reported=None) -> bool:
    """Whether the cell reports the metric: the cells it lists, or with
    no list, every cell (end-to-end) or every cell that reports the
    metric it moves (per-layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def find(root: str, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its parts loaded."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    driver = importlib.import_module("drivers." + traffic["driver"])
    limits_path = os.path.join(bench_dir, "limits", name + ".json")
    limits = _load(limits_path) if os.path.exists(limits_path) else {}
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), config, traffic, driver, limits, e2e,
                per_layer)
