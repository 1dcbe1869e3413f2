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
    # the program's own spans and counters, on over a traced window; what
    # needs the card's clock or its profile is left out on the CPU
    mppi = cell.traffic["driver"] == "mppi"
    for name in (("useful_forward_share.mppi", "valid_edge_share.mppi")
                 if mppi else ("fps_host_ms.train",)):
        assert out["metrics"][name]["value"] > 0, name
    for name in (("incidence_ms.mppi", "relation_mlp_ms.mppi") if mppi
                 else ("fps_launches_per_step.train",
                       "prepare_idle_share.train")):
        assert name not in out["metrics"], name


def test_same_seed_same_inputs():
    """What a run draws from its seed (weights, the cloud target) repeats
    bit for bit on the same seed."""
    import torch

    from harness import inputs
    from reference import model as ref_model
    cell = cells.find(ROOT, "rope.mppi")
    cfg, cpu = cell.config, torch.device("cpu")
    tc = cfg["published"]["planning"]
    shapes = ref_model.layer_shapes(*ref_model.widths(
        cfg["published"]["dynamics"]["model_config"], 4, 1))
    state, mask = inputs.planning_state(cfg["assumed"]["object"], tc, cpu)
    runs = [(inputs.weights(shapes, cfg["assumed"]["weights"], 2**31 + 5,
                            cpu),
             inputs.planning_target(2**31 + 5, state, mask, tc,
                                    cfg["assumed"]["target"], cpu))
            for _ in range(2)]
    (w_a, t_a), (w_b, t_b) = runs
    assert all(torch.equal(w_a[k], w_b[k]) for k in w_a)
    assert torch.equal(t_a, t_b)
