"""Run one cell of the benchmark with the port's own tracer on over the
window, and print what its spans and counters give.

    python3 benchmark/program_trace.py --workload <cell> --seed <n>
                                       --seconds <s> --trace <0|1>

The cell runs as benchmark/run.py runs it (run.run_cell: set-up, warm-up,
window, check), with adaptigraph_torch.utils.profiling reset and enabled
just before the window and exported just after it (harness/program.py),
with --trace 0 too.
The last line of standard output is run.py's result line with one more
key, "program":

  * with --trace 1: the per-layer numbers the program's spans and
    counters give (harness/program.metrics), each span name's count and
    medians (host ms, device ms), the profiled segment's runtime launch
    calls and device idle seconds by innermost span, and the agreement of
    the program's spans with the harness's own hooks over the same window
    (harness/program.agreement);
  * with --trace 0: the tracer's counts alone, so that the end-to-end
    metrics beside them give the tracer's cost when on (against a
    run.py --trace 0 run on the same seed).

With --out <file>, the tracer's whole export is written there as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict


import run as runner
from harness import cells, guard, program

BENCH_DIR, ROOT = runner.BENCH_DIR, runner.ROOT


def traced(cell, seed: int, seconds: float, trace: bool, device, t0: float,
           sizes=None, say=print):
    """run.run_cell with the program's tracer on over the window: (the
    result line's dict with its "program" key, the tracer's export)."""
    keep = {}
    out = runner.run_cell(cell, seed, seconds, trace, device, t0, sizes, say,
                          tracer=True, keep=keep)
    prog, run = keep["program"], keep["run"]
    by = defaultdict(list)
    for s in prog["spans"]:
        by[s["name"]].append(s)
    summary = {
        "counters": prog["counters"],
        "spans": {n: {"count": len(v),
                      "host_ms_median": program.median(
                          [(s["end_ns"] - s["start_ns"]) / 1e6 for s in v]),
                      "device_ms_median": program.median(
                          [s["device_ms"] for s in v])}
                  for n, v in sorted(by.items())}}
    if trace:
        summary["metrics"] = program.metrics(prog, run)
        summary["launches"] = prog["launches"]
        summary["idle_s"] = prog["idle_s"]
        summary["agreement"] = program.agreement(prog, run.spans.ms(), run)
    out["program"] = summary
    return out, prog


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    t0 = runner.time.perf_counter() - runner._process_age()
    if guard.refused_env():
        print("refused: ADAPTIGRAPH_GNN_AGG or ADAPTIGRAPH_GNN_DTYPE set",
              file=sys.stderr)
        return 2
    guard.set_cache_dirs(BENCH_DIR)
    import torch
    cell = cells.find(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no card: {args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 3
    out, export = traced(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda"), t0)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(export, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
