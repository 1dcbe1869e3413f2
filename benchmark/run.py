"""Run one cell of the benchmark of adaptigraph_torch on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

One process a run: it loads the port, makes the cell's weights and inputs
on the card from the seed (a planning cell's perceived scene from its
configuration's own scene seed), warms up the cell's own shapes (all of
that is set-up), measures for --seconds (closing at the end of the
planning call or train chunk in progress), then checks what the window
produced against the plain reference under benchmark/reference/. With
--trace 0 the last line of standard output carries the cell's end-to-end
metrics; with --trace 1 its per-layer metrics, read from harness-side
spans, from the program's own spans and counters
(adaptigraph_torch.utils.profiling, on over a traced run's window only)
and from torch.profiler over a steady segment of the window. Every number
compared is printed beside its limit, as the last lines of standard error
and under the last key of the result line.

Exits with a code other than 0, printing no result, when no card (or too
few) is present, when ADAPTIGRAPH_GNN_AGG or ADAPTIGRAPH_GNN_DTYPE is set,
or when a module of JAX or of the JAX package has been loaded.
"""

from __future__ import annotations

import time

_T_ENTRY = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

from harness import cells, guard  # noqa: E402


def _process_age() -> float:
    """Seconds since this process started (the kernel's record of it),
    or since this module began where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"),
                   time.perf_counter() - _T_ENTRY)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_ENTRY


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float, sizes=None, say=print, tracer=None,
             keep=None) -> dict:
    """Set up, warm up, measure and check one cell; the result line's
    dict. t0 is the process's start on the perf_counter clock. The
    program's own tracer (harness/program.py) is on over the window when
    `tracer` is true, by default in a traced run only; `keep`, a dict,
    receives the run and the tracer's export."""
    import torch

    from harness import program
    from harness.precision import matmul_precision
    from harness.trace import Profiled, Spans

    marks = {"imports": time.perf_counter() - t0}
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device).sum().item()
    marks["cuda_context"] = time.perf_counter() - t0
    spans = Spans(trace)
    run = cell.driver.Run(cell.config, cell.traffic, seed, device, spans,
                          sizes)
    if device.type == "cuda":
        torch.cuda.synchronize()
    marks["weights_and_inputs"] = time.perf_counter() - t0
    run.warm_up()
    setup_s = time.perf_counter() - t0
    marks["warm_up"] = setup_s
    say(json.dumps({"setup_marks_s": marks,
                    "inputs_marks_s": getattr(run, "marks", {}),
                    "scene": getattr(run, "scene", None),
                    "aggregation": run.mode[0],
                    "dtype": run.mode[1],
                    "allow_tf32": torch.backends.cuda.matmul.allow_tf32}),
        flush=True)

    profiled = Profiled() if trace else None
    tracer = trace if tracer is None else tracer
    if tracer:
        program.start()
    w = run.window(seconds, profiled)
    # before profiled.summary(), which drops the raw profile
    prog = program.finish(profiled) if tracer else None
    if keep is not None:
        keep.update(run=run, program=prog)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    span_ms = spans.ms() if trace else {}
    profile = profiled.summary() if trace else None
    run.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        say(json.dumps({"card": power_limit(), "window_s": w["wall_s"]}),
            flush=True)

    with matmul_precision("f32"):
        readings = run.check()
    checks = {k: [readings[k], lim] for k, lim in cell.limits.items()}
    correct = bool(checks) and all(
        v <= lim for v, lim in checks.values())
    say(json.dumps({"readings": readings,
                    "left_out": getattr(run, "left_out", [])}), flush=True)

    metrics = {}
    if not trace:
        values = dict(run.end_to_end(w), setup_s=(setup_s, "s"))
        for m in cell.end_to_end:
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    else:
        t = SimpleNamespace(spans=span_ms, counters=dict(spans.counters),
                            profile=profile, run=run, window=w,
                            program=prog)
        for m in cell.per_layer:
            v = cells.reader(BENCH_DIR, m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": w["attempted"], "failed": 0,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        out["breakdown"] = profile["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter() - _process_age()

    refused = guard.refused_env()
    if refused:
        print(f"refused: {', '.join(refused)} set; the benchmark runs the "
              f"port's default aggregation and precision", file=sys.stderr)
        return 2
    guard.set_cache_dirs(BENCH_DIR)
    import torch
    cell = cells.find(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no card: {args.workload} needs {cell.chips} CUDA device(s), "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), t0)
    loaded = guard.refused_modules()
    if loaded:
        print(f"refused modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
