"""Depth post-processing: the librealsense filter chain, reimplemented in
numpy; the port of adaptigraph_tpu/planning/real_world/depth_filters.py.

The reference's SingleRealsense.depth_process
(src/planning/real_world/camera/single_realsense.py:213-231):

    depth -> disparity -> spatial_filter(magnitude=5, smooth_alpha=0.75,
    smooth_delta=1, holes_fill=1) -> temporal_filter(smooth_alpha=0.75,
    smooth_delta=1) -> depth

pyrealsense2 is a hardware-only dependency, so the chain is reimplemented
in numpy with the same algorithm librealsense documents for these filters:

  * disparity transform: d = k / depth (the filter operates in disparity
    space so smoothing respects 1/z perceptual uniformity);
  * spatial filter: `magnitude` iterations of a 1-D recursive exponential
    (alpha) smoother swept left->right, right->left, top->bottom,
    bottom->top, updating a pixel only when the disparity step to its
    predecessor is below `delta` (edge-preserving) — librealsense's
    "domain-transform" 1-D EMA; holes_fill=1 fills invalid pixels from the
    nearest valid neighbor within a 2-px scan radius;
  * temporal filter: per-pixel EMA across frames, again gated by `delta`,
    with invalid pixels inheriting the last valid history value
    (persistence).

The processor is stateful (temporal history), one instance per camera
stream — mirroring librealsense, where the temporal filter object carries
the history.
"""

from __future__ import annotations

import numpy as np

# librealsense uses d = baseline*fx/z; any positive constant gives the same
# filter behavior up to delta scaling. Keep RS's D435 default-ish constant
# so smooth_delta=1 means "1 disparity unit" as in the reference options.
_DISPARITY_K = 50_000.0  # mm * disparity-units


def _to_disparity(depth_mm: np.ndarray) -> np.ndarray:
    d = np.zeros(depth_mm.shape, np.float32)
    valid = depth_mm > 0
    d[valid] = _DISPARITY_K / depth_mm[valid].astype(np.float32)
    return d


def _to_depth(disp: np.ndarray) -> np.ndarray:
    depth = np.zeros(disp.shape, np.float32)
    valid = disp > 0
    depth[valid] = _DISPARITY_K / disp[valid]
    return np.clip(depth, 0, np.iinfo(np.uint16).max).astype(np.uint16)


def _ema_pass(disp: np.ndarray, alpha: float, delta: float, axis: int,
              reverse: bool) -> np.ndarray:
    """One directional recursive EMA sweep, edge- and hole-aware.

    Vectorized over rows: iterate along `axis`, carrying the previous
    column/row; update only where both pixels are valid and the disparity
    step is under `delta`.
    """
    d = disp if axis == 1 else disp.T
    if reverse:
        d = d[:, ::-1]
    d = d.copy()
    prev = d[:, 0].copy()
    for j in range(1, d.shape[1]):
        cur = d[:, j]
        ok = (cur > 0) & (prev > 0) & (np.abs(cur - prev) < delta)
        cur = np.where(ok, alpha * cur + (1.0 - alpha) * prev, cur)
        d[:, j] = cur
        prev = cur
    if reverse:
        d = d[:, ::-1]
    return d if axis == 1 else d.T


def _fill_holes(disp: np.ndarray, radius: int = 2) -> np.ndarray:
    """holes_fill=1: fill invalid pixels from the nearest valid pixel to
    the left within `radius` (librealsense's smallest fill setting scans
    along the filter direction)."""
    out = disp.copy()
    for _ in range(radius):
        hole = out <= 0
        left = np.concatenate([out[:, :1], out[:, :-1]], axis=1)
        out = np.where(hole & (left > 0), left, out)
    return out


def spatial_filter(disp: np.ndarray, magnitude: int = 5, alpha: float = 0.75,
                   delta: float = 1.0, holes_fill: int = 1) -> np.ndarray:
    """rs.spatial_filter(magnitude, smooth_alpha, smooth_delta, holes_fill)
    over a disparity image (single_realsense.py:217-221)."""
    d = disp
    for _ in range(int(magnitude)):
        d = _ema_pass(d, alpha, delta, axis=1, reverse=False)
        d = _ema_pass(d, alpha, delta, axis=1, reverse=True)
        d = _ema_pass(d, alpha, delta, axis=0, reverse=False)
        d = _ema_pass(d, alpha, delta, axis=0, reverse=True)
    if holes_fill:
        d = _fill_holes(d, radius=2 * int(holes_fill))
    return d


class TemporalFilter:
    """rs.temporal_filter(smooth_alpha, smooth_delta) with persistence
    (single_realsense.py:223-225): per-pixel EMA across frames; invalid
    pixels inherit the history value."""

    def __init__(self, alpha: float = 0.75, delta: float = 1.0):
        self.alpha = alpha
        self.delta = delta
        self._hist = None

    def __call__(self, disp: np.ndarray) -> np.ndarray:
        if self._hist is None:
            self._hist = disp.copy()
            return disp
        h = self._hist
        valid = disp > 0
        near = valid & (h > 0) & (np.abs(disp - h) < self.delta)
        out = np.where(near, self.alpha * disp + (1.0 - self.alpha) * h, disp)
        out = np.where(~valid & (h > 0), h, out)  # persistence fill
        self._hist = out.copy()
        return out


class DepthProcessor:
    """The full chain of single_realsense.py:213-231, stateful per stream."""

    def __init__(self, magnitude: int = 5, spatial_alpha: float = 0.75,
                 spatial_delta: float = 1.0, holes_fill: int = 1,
                 temporal_alpha: float = 0.75, temporal_delta: float = 1.0):
        self.magnitude = magnitude
        self.spatial_alpha = spatial_alpha
        self.spatial_delta = spatial_delta
        self.holes_fill = holes_fill
        self.temporal = TemporalFilter(temporal_alpha, temporal_delta)

    def __call__(self, depth_mm: np.ndarray) -> np.ndarray:
        disp = _to_disparity(depth_mm)
        disp = spatial_filter(disp, self.magnitude, self.spatial_alpha,
                              self.spatial_delta, self.holes_fill)
        disp = self.temporal(disp)
        return _to_depth(disp)
