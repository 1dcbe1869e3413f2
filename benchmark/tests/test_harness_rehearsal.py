"""A tiny rehearsal of each cell on the CPU through run.run_cell: the last
line's schema, the metrics the cell reports and a correct check."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT
from harness import cells

WORKLOADS = [w["name"] for w in json.load(open(f"{ROOT}/BENCHMARK.json"))
             ["workloads"]]


def _schema(out, metric_names):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) <= metric_names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_measured_run(rehearse, workload):
    cell = cells.find(ROOT, workload)
    out = rehearse(workload)
    _schema(out, {m["name"] for m in cell.end_to_end})
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(out["checks"]) == set(cell.limits)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run(rehearse, workload):
    cell = cells.find(ROOT, workload)
    out = rehearse(workload, trace=True)
    _schema(out, {m["name"] for m in cell.per_layer})
    assert set(out["device"]) >= {"busy_s", "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"], out["checks"]
    mfu = [k for k in out["metrics"] if "mfu" in k]
    assert mfu and all(0 < out["metrics"][k]["value"] < 100 for k in mfu)


def test_same_seed_same_inputs():
    import torch

    from harness import inputs
    cell = cells.find(ROOT, "rope.mppi")
    tc = cell.config["published"]["planning"]
    a = inputs.planning_state(2**31 + 5, cell.config["assumed"]["object"], tc,
                              torch.device("cpu"))
    b = inputs.planning_state(2**31 + 5, cell.config["assumed"]["object"], tc,
                              torch.device("cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert 10 < int(a[1].sum()) < 200
