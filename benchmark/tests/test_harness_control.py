"""The control: the reference put in the program's place with its
products in TF32, the precision below the configurations' float32 with
TF32 off, has to come out not correct. On the CPU at tiny sizes, TF32 is
emulated by rounding each product's operands; on a card, at the cells'
own sizes on three seeds, the card's TF32 is used."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT, tiny
from harness import cells

WORKLOADS = [w["name"] for w in json.load(open(f"{ROOT}/BENCHMARK.json"))
             ["workloads"]]


def _control(cell, seed, device, sizes):
    from harness.precision import matmul_precision
    from harness.trace import Spans
    run = cell.driver.Run(cell.config, cell.traffic, seed, device,
                          Spans(False), sizes)
    run.warm_up()
    run.window(0.0)
    run.free()
    with matmul_precision("f32"):
        program = run.check()
        control = run.check(stand_in=run.control("tf32"))

    def ok(r):
        return all(r[k] <= lim for k, lim in cell.limits.items())
    return ok(program), ok(control)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_the_cpu(workload):
    torch.set_num_threads(2)
    cell = cells.find(ROOT, workload)
    program_ok, control_ok = _control(cell, 31, torch.device("cpu"),
                                      tiny(cell))
    assert program_ok and not control_ok


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = cells.find(ROOT, workload)
    for seed in (71, 72, 73):
        program_ok, control_ok = _control(cell, seed, torch.device("cuda"),
                                          None)
        assert program_ok and not control_ok
