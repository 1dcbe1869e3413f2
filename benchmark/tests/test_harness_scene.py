"""Each planning configuration fixes the scene its planner perceives: the
run's seed draws the weights, the noise, the checked rows and the target,
never the perceived points, whose count sets the rollout's work. The
configuration's scene seed follows a rule, not a scene's speed."""

from __future__ import annotations

import json
import statistics

import pytest

from conftest import ROOT, tiny
from harness import cells


def _driver(traffic):
    with open(f"{ROOT}/benchmark/traffic/{traffic}.json") as f:
        return json.load(f)["driver"]


with open(f"{ROOT}/BENCHMARK.json") as _f:
    PLANNING = [w["name"] for w in json.load(_f)["workloads"]
                if _driver(w["traffic"]) == "mppi"]
SEEDS = (2_500_000_017, 3_000_000_019)


@pytest.mark.parametrize("workload", PLANNING)
def test_two_run_seeds_plan_from_one_scene(workload):
    import torch

    from harness.trace import Spans
    torch.set_num_threads(2)
    cell = cells.find(ROOT, workload)
    a, b = (cell.driver.Run(cell.config, cell.traffic, s,
                            torch.device("cpu"), Spans(False), tiny(cell))
            for s in SEEDS)
    assert torch.equal(a.state, b.state) and torch.equal(a.mask, b.mask)
    assert a.scene == b.scene
    assert int(a.mask.sum()) == cell.config["assumed"]["object"]["perceived"]
    assert not any(torch.equal(a.weights[k], b.weights[k])
                   for k in a.weights)
    noise_a, noise_b = (torch.rand(8, generator=r.noise_gen) for r in (a, b))
    assert not torch.equal(noise_a, noise_b)


@pytest.mark.parametrize("workload", PLANNING)
def test_scene_seed_follows_the_rule(workload):
    """scene_seed is the smallest of scene seeds 0-63 whose perceived
    count is the lower median of their 64 counts."""
    from harness import inputs
    cell = cells.find(ROOT, workload)
    scene = cell.config["assumed"]["object"]
    tc = cell.config["published"]["planning"]
    counts = [inputs.perceived_points(s, scene, tc).shape[0]
              for s in range(64)]
    median = statistics.median_low(counts)
    assert scene["perceived"] == median
    assert scene["scene_seed"] == counts.index(median)


def test_a_scene_that_perceives_another_count_is_refused():
    import torch

    from harness import inputs
    cell = cells.find(ROOT, "rope.mppi")
    scene = dict(cell.config["assumed"]["object"])
    scene["perceived"] += 1
    with pytest.raises(ValueError, match="perceives"):
        inputs.planning_state(scene, cell.config["published"]["planning"],
                              torch.device("cpu"))
