"""Timestamp alignment for multi-source capture streams: the port of
adaptigraph_tpu/planning/real_world/timestamp.py (numpy only).

As the reference's common/timestamp_accumulator.py:6-222, it maps
asynchronous per-camera/robot samples onto a fixed-rate global clock so
downstream consumers see one aligned timeline. Covers the full accumulator
machinery: tick filling with dropped-frame repeats, target-tick alignment,
and the growing observation/action buffers (obs forward-fills monotonic
ticks; actions may overwrite earlier ticks).
"""

from __future__ import annotations

import numpy as np


def tick_fill_indices(timestamps, start_time: float, dt: float,
                      eps: float = 1e-5, next_tick: int | None = 0,
                      allow_negative: bool = False):
    """Map sorted source timestamps onto consecutive global ticks.

    Each dt-window tick is served by the FIRST sample at-or-after it; a
    sample may serve several ticks when frames were dropped (the reference's
    get_accumulate_timestamp_idxs semantics, timestamp_accumulator.py:6-41,
    expressed vectorized).

    Returns (local_idxs, global_idxs, next_tick): parallel lists mapping
    source index -> global tick, plus the tick to resume from. `next_tick=
    None` starts at the first sample's own tick (overwrite mode).
    """
    ts = np.atleast_1d(np.asarray(timestamps, np.float64))
    g = np.floor((ts - start_time) / dt + eps).astype(np.int64)
    if not allow_negative:
        keep = g >= 0
        ts, g = ts[keep], g[keep]
    if len(g) == 0:
        return [], [], (0 if next_tick is None else next_tick)
    if next_tick is None:
        next_tick = int(g[0])
    last = int(g[-1])
    if last < next_tick:
        return [], [], next_tick
    wanted = np.arange(next_tick, last + 1)
    # first sample whose tick >= wanted tick serves it
    local = np.searchsorted(g, wanted, side="left")
    ok = local < len(g)
    return (local[ok].astype(int).tolist(), wanted[ok].astype(int).tolist(),
            last + 1)


def align_to_ticks(timestamps, target_ticks, start_time: float, dt: float,
                   eps: float = 1e-5):
    """Local sample index for each requested global tick (the reference's
    align_timestamps, :44-77): truncate extras, pad by repeating the last
    sample for missing ticks."""
    target_ticks = list(np.asarray(target_ticks).tolist())
    assert target_ticks, "need at least one target tick"
    local, global_idxs, _ = tick_fill_indices(
        timestamps, start_time, dt, eps=eps, next_tick=target_ticks[0],
        allow_negative=True)
    local = local[: len(target_ticks)]
    n_missing = len(target_ticks) - len(local)
    local.extend([len(np.atleast_1d(timestamps)) - 1] * n_missing)
    return local


class _GrowingBuffer:
    """Doubling flat buffer keyed write helper."""

    @staticmethod
    def ensure(arr, size):
        if len(arr) >= size:
            return arr
        new = np.zeros((max(size, 2 * len(arr)),) + arr.shape[1:], arr.dtype)
        new[: len(arr)] = arr
        return new


class ObsAccumulator:
    """Accumulate observation dicts onto the global clock
    (TimestampObsAccumulator, :79-150): ticks fill monotonically; dropped
    frames repeat the previous sample."""

    def __init__(self, start_time: float, dt: float, eps: float = 1e-5):
        self.start_time = start_time
        self.dt = dt
        self.eps = eps
        self.buffers: dict[str, np.ndarray] = {}
        self.ts_buffer = np.zeros((0,), np.float64)
        self.next_tick = 0

    def __len__(self):
        return self.next_tick

    @property
    def data(self):
        return {k: v[: len(self)] for k, v in self.buffers.items()}

    @property
    def actual_timestamps(self):
        return self.ts_buffer[: len(self)]

    @property
    def timestamps(self):
        return self.start_time + np.arange(len(self)) * self.dt

    def put(self, data: dict, timestamps):
        local, ticks, self.next_tick = tick_fill_indices(
            timestamps, self.start_time, self.dt, self.eps, self.next_tick)
        if not ticks:
            return
        size = ticks[-1] + 1
        for key, value in data.items():
            value = np.asarray(value)
            if key not in self.buffers:
                self.buffers[key] = np.zeros((0,) + value.shape[1:], value.dtype)
            self.buffers[key] = _GrowingBuffer.ensure(self.buffers[key], size)
            self.buffers[key][ticks] = value[local]
        self.ts_buffer = _GrowingBuffer.ensure(self.ts_buffer, size)
        self.ts_buffer[ticks] = np.atleast_1d(np.asarray(timestamps))[local]


class ActionAccumulator:
    """Accumulate issued actions onto the global clock
    (TimestampActionAccumulator, :153-222): later puts may OVERWRITE earlier
    ticks (re-planning)."""

    def __init__(self, start_time: float, dt: float, eps: float = 1e-5):
        self.start_time = start_time
        self.dt = dt
        self.eps = eps
        self.buffer = None
        self.ts_buffer = np.zeros((0,), np.float64)
        self.size = 0

    def __len__(self):
        return self.size

    @property
    def actions(self):
        if self.buffer is None:
            return np.array([])
        return self.buffer[: len(self)]

    @property
    def actual_timestamps(self):
        return self.ts_buffer[: len(self)]

    @property
    def timestamps(self):
        return self.start_time + np.arange(len(self)) * self.dt

    def put(self, actions, timestamps):
        actions = np.asarray(actions)
        local, ticks, _ = tick_fill_indices(
            timestamps, self.start_time, self.dt, self.eps, next_tick=None)
        if not ticks:
            return
        size = ticks[-1] + 1
        if self.buffer is None:
            self.buffer = np.zeros((0,) + actions.shape[1:], actions.dtype)
        self.buffer = _GrowingBuffer.ensure(self.buffer, size)
        self.ts_buffer = _GrowingBuffer.ensure(self.ts_buffer, size)
        self.buffer[ticks] = actions[local]
        self.ts_buffer[ticks] = np.atleast_1d(np.asarray(timestamps))[local]
        self.size = max(self.size, size)


# ---------------------------------------------------------------------------
# legacy single-stream helper kept for RealEnv.get_obs alignment


class TimestampAccumulator:
    """Accumulates (timestamp, index) samples and exposes which global ticks
    each sample covers."""

    def __init__(self, start_time: float, dt: float, eps: float = 1e-5):
        self.start_time = start_time
        self.dt = dt
        self.eps = eps
        self.timestamps = []  # aligned per-tick source timestamps
        self.indices = []  # source sample index per tick

    def global_idx(self, t: float) -> int:
        return int(np.floor((t - self.start_time + self.eps) / self.dt))

    def put(self, sample_timestamps, sample_indices=None):
        """Register new source samples; each fills every not-yet-covered
        global tick up to its own tick."""
        sample_timestamps = np.atleast_1d(np.asarray(sample_timestamps, np.float64))
        if sample_indices is None:
            sample_indices = np.arange(len(sample_timestamps)) + (
                self.indices[-1] + 1 if self.indices else 0)
        sample_indices = np.atleast_1d(np.asarray(sample_indices))
        for ts, idx in zip(sample_timestamps, sample_indices):
            tick = self.global_idx(ts)
            if tick < 0:
                continue
            while len(self.timestamps) <= tick:
                self.timestamps.append(ts)
                self.indices.append(int(idx))
            self.timestamps[tick] = ts
            self.indices[tick] = int(idx)

    def __len__(self):
        return len(self.timestamps)

    def get(self):
        return np.asarray(self.timestamps), np.asarray(self.indices)


def align_obs(streams: dict, dt: float, start_time: float | None = None):
    """Align multiple {name: (timestamps, payload_indices)} streams onto a
    common clock; returns per-tick index maps for ticks covered by ALL
    streams (the RealEnv.get_obs alignment, real_env.py:152-198)."""
    if start_time is None:
        start_time = max(ts[0] for ts, _ in streams.values())
    accs = {}
    for name, (ts, idx) in streams.items():
        acc = TimestampAccumulator(start_time, dt)
        acc.put(ts, idx)
        accs[name] = acc
    n = min(len(a) for a in accs.values())
    return {name: np.asarray(a.indices[:n]) for name, a in accs.items()}
