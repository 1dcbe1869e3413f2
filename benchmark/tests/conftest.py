"""The benchmark's own tests: run from the repository's root with
`python -m pytest benchmark/tests -q`. Tests marked `card` need a CUDA
device and skip inside their bodies without one; the rest run on the CPU
at tiny sizes."""

from __future__ import annotations

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


def tiny(cell):
    """Sizes that make a cell's run take seconds on the CPU: a small
    population and short pushes, or a small batch, chunk and data."""
    if cell.traffic["driver"] == "mppi":
        tc = cell.config["published"]["planning"]
        return {"task": {"n_sample": 24, "n_sample_chunk": 8,
                         "action_lower_lim": tc["action_lower_lim"][:3] + [1],
                         "action_upper_lim": tc["action_upper_lim"][:3] + [3]},
                "checked_rows": 8, "longest_rows": 2}
    return {"batch_size": 4, "steps_per_chunk": 3,
            "episodes": {"count": 2, "frames": 40, "points": 300}}


@pytest.fixture
def rehearse():
    """rehearse(workload, trace=False, seed=...) -> the result line's dict
    of a CPU run of the cell at tiny sizes, through run.run_cell."""
    import time

    import torch

    import run as runner
    from harness import cells

    def go(workload, trace=False, seed=2_500_000_017):
        torch.set_num_threads(2)
        cell = cells.find(ROOT, workload)
        return runner.run_cell(cell, seed, 0.0, trace, torch.device("cpu"),
                               time.perf_counter(), sizes=tiny(cell),
                               say=lambda *a, **k: None)
    return go
