"""The program's own tracer in the benchmark's runs (harness/program.py,
program_trace.py): a tiny CPU rehearsal of each cell with the tracer on,
an untraced run that records nothing, and the attribution of launches and
idle gaps to the innermost span on a synthetic timeline."""

from __future__ import annotations

import json
import time

import pytest

from conftest import ROOT, tiny
from harness import cells, program

WORKLOADS = [w["name"] for w in json.load(open(f"{ROOT}/BENCHMARK.json"))
             ["workloads"]]
SEED = 2_500_000_017


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_rehearsal_reports_the_program_metrics(workload):
    import torch

    import program_trace
    torch.set_num_threads(2)
    cell = cells.find(ROOT, workload)
    out, export = program_trace.traced(
        cell, SEED, 0.0, True, torch.device("cpu"), time.perf_counter(),
        sizes=tiny(cell), say=lambda *a, **k: None)
    assert out["correct"], out["checks"]
    got = out["program"]["metrics"]
    if cell.traffic["driver"] == "mppi":
        for name in ("useful_forward_share.mppi", "valid_edge_share.mppi"):
            assert 0 < got[name] < 1, (name, got)
        # device times need the card
        assert got["incidence_ms.mppi"] is None
        agree = out["program"]["agreement"]
        assert set(agree) == {
            "rollout.forward~forward", "rollout.edges~edges",
            "plan.score~cost",
            "rollout.sample_forwards_needed~forwards_needed"}
        counted, checked = agree[
            "rollout.sample_forwards_needed~forwards_needed"]
        assert counted == checked > 0
    else:
        assert got["fps_host_ms.train"] > 0
        # launches and device idle need the card
        assert got["fps_launches_per_step.train"] is None
        assert got["prepare_idle_share.train"] is None
    assert export["spans"] and not out["program"]["launches"]


def test_untraced_run_records_no_program_span(rehearse):
    from adaptigraph_torch.utils import profiling
    profiling.reset()
    rehearse("rope.train")
    out = profiling.export()
    assert out["spans"] == [] and out["counters"] == {}


def test_attribution_to_the_innermost_span():
    """Launch calls and idle gaps go to the span the host was innermost in
    when the call was issued or the gap began; "none" outside every span.
    Times: spans in Unix ns, events in us, as the profiler gives them."""
    def sp(sid, name, t0, t1):
        return {"id": sid, "name": name, "start_unix_ns": t0 * 1000,
                "end_unix_ns": t1 * 1000}
    spans = [sp(0, "step", 100, 200), sp(1, "prepare", 110, 150),
             sp(2, "fps", 120, 130)]
    cpu = [("cudaLaunchKernel", 105, 106), ("cudaLaunchKernel", 125, 126),
           ("cudaMemcpyAsync", 127, 128), ("aten::add", 128, 129),
           ("cudaMemsetAsync", 140, 141), ("cudaLaunchKernel", 210, 211)]
    dev = [("k0", 100, 104), ("k1", 106, 121), ("bench:label", 121, 200),
           ("k2", 124, 135), ("k3", 130, 145), ("k4", 146, 160),
           ("k5", 212, 215)]
    out = program.attribute(spans, dev, cpu)
    assert out["launches"] == {"step": 1, "fps": 2, "prepare": 1,
                               "none": 1}
    # gaps: 104-106 (step), 121-124 (fps), 145-146 (prepare),
    # 160-212 (step at 160, the harness's own label ignored)
    assert out["idle_s"] == pytest.approx({"step": 54e-6, "fps": 3e-6,
                                           "prepare": 1e-6})
    tail = program.attribute(spans, [("k", 190, 195), ("k", 230, 240)], [])
    assert tail["idle_s"] == pytest.approx({"step": 35e-6})
    late = program.attribute(spans, [("k", 250, 255), ("k", 260, 265)], [])
    assert late["idle_s"] == pytest.approx({"none": 5e-6})
