"""The traced run's instruments: spans timed by CUDA events around the
calls into each layer, counters, and torch.profiler over a steady segment
of the window (device busy time, kernels by time, idle gaps by what the
host was doing).

A span's two events are recorded on the current stream between the
layer's own kernels, so their elapsed time is the device's time from the
layer's first kernel to its last, idle waits inside it included.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


class Spans:
    """Named CUDA-event spans and counters. Disabled, it records
    nothing and costs a branch a call."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._open = {}
        self._pairs = defaultdict(list)
        self.counters = defaultdict(float)

    def _mark(self):
        if torch.cuda.is_available():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()  # a CPU rehearsal: host clock

    def start(self, name: str):
        if self.enabled:
            self._open[name] = self._mark()

    def stop(self, name: str, tag=None):
        if self.enabled and name in self._open:
            self._pairs[name].append((self._open.pop(name), self._mark(),
                                      tag))

    @contextlib.contextmanager
    def span(self, name: str, tag=None):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name, tag)

    def count(self, name: str, n: float = 1.0):
        if self.enabled:
            self.counters[name] += n

    def ms(self) -> dict:
        """{name: [(ms, tag), ...]}, after a synchronize."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()

        def ms(a, b):
            return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)
        return {k: [(ms(a, b), tag) for a, b, tag in v]
                for k, v in self._pairs.items()}


def _events(prof):
    """(device, cpu) lists of (name, start_us, end_us) from a profile."""
    dev, cpu = [], []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            kind = str(e.device_type())
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            (dev if kind.endswith("CUDA") else cpu).append(
                (e.name(), start, end))
    except AttributeError:  # older profilers: the function events
        for e in prof.events():
            kind = str(getattr(e, "device_type", ""))
            rng = (e.time_range.start, e.time_range.end)
            (dev if kind.endswith("CUDA") else cpu).append((e.key, *rng))
    return dev, cpu


def summarize(prof, window_s: float, host_prefix: str = "bench:") -> dict:
    """busy_s (the union of device operations' intervals), the window,
    the device operations count, the top operations by time and the
    longest idle gaps summed by the host's activity at their start: the
    innermost harness span there and the innermost host operation."""
    dev, cpu = _events(prof)
    # the harness's own labels also appear on the device's timeline
    dev = [e for e in dev if not e[0].startswith(host_prefix)]
    if not dev:
        return {"busy_s": 0.0, "window_s": window_s, "device_ops": 0,
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    dev.sort(key=lambda e: e[1])
    starts = np.array([e[1] for e in dev])
    ends = np.array([e[2] for e in dev])
    reach = np.maximum.accumulate(ends)
    busy = 0.0
    cur_s, cur_e = starts[0], ends[0]
    for s, e in zip(starts[1:], ends[1:]):
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s

    by_name = defaultdict(float)
    for name, s, e in dev:
        by_name[name[:120]] += (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    gap_len = starts[1:] - reach[:-1]
    order = np.argsort(-gap_len)[:300]
    order = order[gap_len[order] > 0]
    gaps = defaultdict(float)
    if len(order) and cpu:
        c_start = np.array([c[1] for c in cpu])
        c_end = np.array([c[2] for c in cpu])
        names = [c[0] for c in cpu]
        spans = np.array([n.startswith(host_prefix) for n in names])
        for i in order:
            t = reach[i]
            cover = (c_start <= t) & (c_end >= t)
            label = "host idle"
            if cover.any():
                inner = np.flatnonzero(cover & ~spans)
                outer = np.flatnonzero(cover & spans)
                parts = []
                if len(outer):
                    parts.append(names[outer[np.argmax(c_start[outer])]])
                if len(inner):
                    parts.append(names[inner[np.argmax(c_start[inner])]])
                label = "/".join(parts)[:120] or label
            gaps[label] += gap_len[i] / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "window_s": window_s,
            "device_ops": len(dev),
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in idle]}}


class Profiled:
    """torch.profiler over one segment of the window, entered once; read
    it with summary() after the window has closed."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self.window_s = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        return False

    def summary(self) -> dict:
        out = summarize(self._prof, self.window_s)
        self._prof = None
        return out


def host_span(name: str):
    """A host-side label the profiler records (named 'bench:<name>')."""
    return torch.profiler.record_function("bench:" + name)
