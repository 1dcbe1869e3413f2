"""Readings for the limits of a cell's compared numbers, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--control 1,2,3] [--half 1,2,3] [--out FILE]

For each seed: the cell's set-up, its warm-up and a window of one planning
call or one train chunk, then the check: the program's readings. For each
seed of --control, the control as well: the reference in the program's
place, its products in TF32 (the precision below the configuration's
float32 with TF32 off). For each seed of --half (training cells), the
reference in the program's place with half of each batch left out and the
mean taken over the rest. Prints one JSON line a reading; with --out,
appends them to FILE. Needs a card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

from harness import cells, guard  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(cell, seed, device, control=False, half=False, sizes=None):
    """[(kind, readings)] of one seed."""
    import torch

    from harness.precision import matmul_precision
    from harness.trace import Spans

    run = cell.driver.Run(cell.config, cell.traffic, seed, device,
                          Spans(False), sizes)
    run.warm_up()
    run.window(0.0)
    run.free()
    out = []
    with matmul_precision("f32"):
        out.append(("program", run.check()))
    if control:
        out.append(("control", run.check(stand_in=run.control("tf32"))))
    if half:
        out.append(("half", run.check(stand_in=run.control("f32",
                                                           half=True))))
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--half", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if guard.refused_env():
        print("refused: the port's aggregation or precision is set",
              file=sys.stderr)
        return 2
    guard.set_cache_dirs(BENCH_DIR)
    import torch
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 3
    cell = cells.find(ROOT, args.workload)
    control, half = set(_seeds(args.control)), set(_seeds(args.half))
    seeds = _seeds(args.seeds) + sorted((control | half)
                                        - set(_seeds(args.seeds)))
    for seed in seeds:
        for kind, r in readings(cell, seed, torch.device("cuda"),
                                seed in control, seed in half):
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "kind": kind, **r})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
