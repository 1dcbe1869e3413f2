"""Tracing, profiling and metrics hooks: the port of
adaptigraph_tpu/utils/profiling.py.

  * `trace(dir)`: a torch.profiler capture (CPU and, where present, CUDA
    activity) written as a Chrome trace, `dir/trace.json`;
  * `annotate(name)`: torch.profiler.record_function, so host phases show
    up inside the trace;
  * `Timer`: named wall-clock accumulators with EMA smoothing (the
    reference's FleX frame-timer pattern) and a one-line report;
  * `MetricsLogger`: append-only jsonl metrics (loss curves, step rates);
  * `plot_loss_curves`: the train/valid loss png; matplotlib is imported
    only when it is called, and its absence raises ImportError.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: with trace('dump/trace') as prof: run_workload().
    Writes log_dir/trace.json (chrome://tracing, Perfetto) on exit."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Host-side annotation that appears in the trace."""
    return torch.profiler.record_function(name)


class Timer:
    """Named accumulating timers with exponential smoothing
    (the g_smoothing frame-timer pattern, pyflex.cpp:3644-3656)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = {}
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            self.ema[name] = (dt if name not in self.ema
                              else self.alpha * dt
                              + (1 - self.alpha) * self.ema[name])

    def report(self) -> str:
        rows = []
        for name in sorted(self.total):
            n = self.count[name]
            rows.append(f"{name}: {self.total[name] / n * 1000:.2f} ms/call "
                        f"(ema {self.ema[name] * 1000:.2f} ms, n={n})")
        return " | ".join(rows)


class MetricsLogger:
    """Append-only jsonl metrics stream."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def plot_loss_curves(train_losses, valid_losses, out_path: str):
    """Train/valid loss png (train.py:133-145's figure). Raises ImportError
    where matplotlib is not installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 4))
    plt.plot(train_losses, label="train")
    if valid_losses:
        plt.plot(valid_losses, label="valid")
        y_min = min(valid_losses)
        y_max = max(3 * y_min, 1e-12)
        plt.ylim([0, max(y_max, y_min * 1.1)])
    plt.legend()
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.grid(alpha=0.3)
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close()
