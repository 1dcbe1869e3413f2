"""The port's tracer, its operator capture and the loss-curve plot.

  * the tracer: `span(name, tag)` around a layer's call and
    `count(name, n)` at the same boundaries, off until `enable()`.
    Off, `span` returns one shared object that does nothing and `count`
    returns at once. On, a span records its name, id, parent (the
    innermost open span), root (the outermost: all spans of one planning
    call or one train chunk share it), its tag and the host's
    `time.perf_counter_ns()` at entry and exit; where CUDA is present it
    also records a pair of pooled CUDA events on the current stream, so
    that `export()` can give the device's time from the span's first
    operation to its last. A span never calls `record_function` and
    launches nothing on the device, so it adds nothing to a profile's
    device timeline; inside a CUDA graph capture it records nothing.
    Counters take Python numbers or device tensors (summed on the device,
    read once in `export()`), so none waits on the device. The tracer
    is one per process and follows the host thread that drives the
    device;
  * `trace(dir)`: a torch.profiler capture with the tracer on, written as
    `dir/trace.json` (a Chrome trace, the spans as a track of their own
    on the profiler's clock) and `dir/spans.json` (the export);
  * `plot_loss_curves`: the train/valid loss png; matplotlib is imported
    only when it is called, and its absence raises ImportError.

Span host times map onto torch.profiler's clock (Unix-epoch ns) by the
anchor that `enable()` takes: one `(perf_counter_ns, time_ns)` pair.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

_on = False  # the one flag an off span or counter reads


class _Off:
    """The span of a tracer that is off: enters and exits, records
    nothing. One instance serves every call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Store:
    """What the tracer holds between reset() and export()."""

    def __init__(self):
        self.spans = []  # [id, name, tag, parent, root, t0, t1, ev0, ev1, ms]
        self.stack = []  # the open spans' records, outermost first
        self.host = defaultdict(float)  # counters from Python numbers
        self.device = defaultdict(list)  # counters from device tensors
        self.anchor = None
        self.cuda = False


_store = _Store()
_pool = []  # CUDA events for reuse, returned by export() and reset()


def _event():
    """A timing event, recorded with record() on the current stream.
    torch.Event finds that stream in C++, where torch.cuda.Event.record()
    first builds a Python Stream (~10 us of host time beside an H100)."""
    if _pool:
        return _pool.pop()
    return torch.Event(device="cuda", enable_timing=True)


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name, tag):
        self.rec = [len(_store.spans), name, tag, None, None, 0, 0, None,
                    None, None]
        _store.spans.append(self.rec)

    def __enter__(self):
        rec, stack = self.rec, _store.stack
        if stack:
            rec[3], rec[4] = stack[-1][0], stack[-1][4]
        else:
            rec[4] = rec[0]
        stack.append(rec)
        if _store.cuda:
            rec[7] = _event()
            rec[7].record()
        rec[5] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[6] = time.perf_counter_ns()
        if rec[7] is not None:
            rec[8] = _event()
            rec[8].record()
        stack = _store.stack
        if stack and stack[-1] is rec:  # not after a reset() inside it
            stack.pop()
        return False


def span(name: str, tag=None):
    """A context manager around one call of a layer: `with span(name):`.
    `tag` (a number or a string) tells calls apart, such as a batch."""
    if not _on:
        return _OFF
    if _store.cuda and torch.cuda.is_current_stream_capturing():
        return _OFF
    return _Span(name, tag)


def count(name: str, n) -> None:
    """Add `n` to counter `name`: a Python number, or a tensor whose
    elements are summed on its device and read back in export(). Inside a
    CUDA graph capture it counts nothing."""
    if not _on or (_store.cuda and torch.cuda.is_current_stream_capturing()):
        return
    if torch.is_tensor(n):
        _store.device[name].append(n if n.dim() == 0 else n.sum())
    else:
        _store.host[name] += n


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn the tracer on; the first enable() after a reset() takes the
    clocks' anchor."""
    global _on
    if _store.anchor is None:
        _store.anchor = (time.perf_counter_ns(), time.time_ns())
    _store.cuda = torch.cuda.is_available()
    _on = True


def disable() -> None:
    global _on
    _on = False


def _release(rec) -> None:
    """Put a span's events back in the pool."""
    _pool.extend(ev for ev in rec[7:9] if ev is not None)
    rec[7] = rec[8] = None


def reset() -> None:
    """Drop every span and counter (the tracer's state otherwise kept)."""
    global _store
    for rec in _store.spans:
        _release(rec)
    _store = _Store()


def _device_ms() -> None:
    """Each closed span's device ms, its events back in the pool."""
    for rec in _store.spans:
        if rec[7] is not None and rec[8] is not None:
            rec[9] = rec[7].elapsed_time(rec[8])
        _release(rec)


def export() -> dict:
    """Everything recorded since reset(), after one synchronize:
    {"anchor": {perf_counter_ns, time_ns, rule}, "spans": [{id, name,
    tag, parent, root, start_ns, end_ns, start_unix_ns, end_unix_ns,
    device_ms}], "counters": {name: number}}. start_ns and end_ns are
    perf_counter ns; the unix ns are on torch.profiler's clock; device_ms
    is None without CUDA and for a span still open. Device counters are
    read here and folded into the host's, so export() may be called again."""
    s = _store
    if s.cuda and torch.cuda.is_available():
        torch.cuda.synchronize()
    _device_ms()
    for name, parts in s.device.items():
        s.host[name] += torch.stack(parts).sum().item()
    s.device.clear()
    pc, unix = s.anchor or (0, 0)
    shift = unix - pc
    spans = [{"id": r[0], "name": r[1], "tag": r[2], "parent": r[3],
              "root": r[4], "start_ns": r[5], "end_ns": r[6],
              "start_unix_ns": r[5] + shift, "end_unix_ns": r[6] + shift,
              "device_ms": r[9]} for r in s.spans]
    return {"anchor": {"perf_counter_ns": pc, "time_ns": unix,
                       "rule": "unix_ns = perf_counter_ns - "
                               "anchor.perf_counter_ns + anchor.time_ns"},
            "spans": spans, "counters": dict(s.host)}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: with trace('dump/trace') as prof: run_workload().
    Turns the tracer on (from a reset) for its duration and writes
    log_dir/trace.json (chrome://tracing, Perfetto), the program's spans
    a track of their own on the profiler's clock, and log_dir/spans.json,
    the tracer's export."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    enable()
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        disable()
    out = export()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        chrome = json.load(f)
    base = chrome.get("baseTimeNanoseconds", 0)
    pid = 1 << 30  # a process id of its own for the spans' track
    track = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
              "args": {"name": "adaptigraph_torch spans"}}]
    for sp in out["spans"]:
        track.append({"ph": "X", "cat": "program_span", "name": sp["name"],
                      "pid": pid, "tid": 0,
                      "ts": (sp["start_unix_ns"] - base) / 1e3,
                      "dur": (sp["end_ns"] - sp["start_ns"]) / 1e3,
                      "args": {k: sp[k] for k in ("id", "parent", "root",
                                                  "tag", "device_ms")}})
    chrome["traceEvents"] = chrome.get("traceEvents", []) + track
    with open(path, "w") as f:
        json.dump(chrome, f)
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(out, f)


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
