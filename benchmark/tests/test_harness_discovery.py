"""BENCHMARK.json against the contract's shape, and every cell's parts
found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH_DIR, ROOT
from harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_text():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS
             + [m["name"] for m in metrics])
    assert all(NAME.match(n) for n in names)
    assert len(set(WORKLOADS)) == len(WORKLOADS)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_parts_found(workload):
    cell = cells.find(ROOT, workload)
    assert cell.chips == 1
    assert cell.driver.Run is not None
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cells.reader(BENCH_DIR, m["name"]))
    assert cell.limits, "every cell's compared numbers have limits"
    assert cell.config["reduced"] == []
    assert cell.config["precision"] == "float32"


def test_every_config_has_a_cell_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))


# each program metric, its source, and what it reads from _EXPORT
PROGRAM_METRICS = {
    "incidence_ms.mppi": ("program_span", 1.75),
    "relation_mlp_ms.mppi": ("program_span", 6.0),
    "useful_forward_share.mppi": ("program_counter", 0.25),
    "valid_edge_share.mppi": ("program_counter", 0.75),
    "fps_host_ms.train": ("program_span", 2.0),
    "fps_launches_per_step.train": ("program_span", 3.0),
    "prepare_idle_share.train": ("program_span", 0.75),
}


def _span(sid, name, parent=None, tag=None, device_ms=None, host_ms=0.0):
    return {"id": sid, "name": name, "parent": parent, "tag": tag,
            "device_ms": device_ms, "start_ns": 0,
            "end_ns": int(host_ms * 1e6)}


# a tracer's export: one forward at the chunk's batch (8) and one train
# step with its FPS, over a profile of 10 steps
_EXPORT = {
    "spans": [_span(0, "rollout.forward", tag=8, device_ms=10.0),
              _span(1, "model.incidence", 0, device_ms=1.0),
              _span(2, "model.gather", 0, device_ms=0.5),
              _span(3, "model.aggregate", 0, device_ms=0.25),
              _span(4, "model.relation_mlp", 0, device_ms=6.0),
              _span(5, "train.step"),
              _span(6, "prepare.fps", 5, host_ms=2.0)],
    "counters": {"rollout.sample_forwards_needed": 1,
                 "rollout.sample_forwards_run": 4,
                 "rollout.valid_edges": 3, "rollout.edge_slots": 4},
    "launches": {"prepare.fps": 30, "train.forward": 5},
    "idle_s": {"prepare.fps": 0.3, "train.forward": 0.1}}


@pytest.mark.parametrize("name", sorted(PROGRAM_METRICS))
def test_program_metric_listed_and_read(name):
    """The program's span and counter metrics are per-layer entries of the
    cells they read, and each reader takes its number from the tracer's
    export (harness/program.py)."""
    from types import SimpleNamespace
    source, value = PROGRAM_METRICS[name]
    entry = {m["name"]: m for m in BENCH["per_layer"]}[name]
    assert entry["source"] == source
    assert entry["workloads"] == (["rope.train"] if name.endswith(".train")
                                  else ["rope.mppi", "granular.mppi"])
    trace = SimpleNamespace(program=_EXPORT,
                            run=SimpleNamespace(chunk=8, steps_profiled=10))
    assert cells.reader(BENCH_DIR, name)(trace) == pytest.approx(value)
