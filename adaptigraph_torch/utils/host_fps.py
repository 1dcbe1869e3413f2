"""Host-side farthest point sampling, for episode storage, perception and
the rollout evaluator's start graph: the port of
adaptigraph_tpu/utils/host_fps.py.

Greedy max-min over float32 distances with numpy-argmax first-index
tie-breaking, and for the radius variant a random start drawn from the
caller's RandomState. The loop runs natively: native/fps.cpp, built by
kernels.build's host route at first use (`native=True`, the default). The
numpy form (`native=False`) is its plain version: the same index lists,
held to each other by the tests. A native build that fails raises; the
port never falls back to numpy on its own.
"""

from __future__ import annotations

import ctypes

import numpy as np

_I64, _F32 = ctypes.c_int64, ctypes.c_float
_P_F32, _P_I64 = ctypes.POINTER(_F32), ctypes.POINTER(_I64)


def _lib():
    from adaptigraph_torch.kernels import build

    lib = build.load_host("fps")
    lib.fps_indices.restype = _I64
    lib.fps_indices.argtypes = [_P_F32, _I64, _I64, _I64, _P_I64]
    lib.fps_rad_indices.restype = _I64
    lib.fps_rad_indices.argtypes = [_P_F32, _I64, _F32, _I64, _I64, _P_I64]
    return lib


def fps_with_idx(points: np.ndarray, n: int, native: bool = True):
    """Greedy FPS starting at index 0; returns (points[idx], idx)."""
    if n >= len(points):
        return points, np.arange(len(points))
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if native:
        out = np.empty(n, np.int64)
        got = _lib().fps_indices(pts.ctypes.data_as(_P_F32), len(pts), n, 0,
                                 out.ctypes.data_as(_P_I64))
        idx = out[:got]
        return points[idx], idx
    idx = [0]
    dist = np.full(len(pts), np.inf, np.float32)
    for _ in range(1, n):
        d = np.linalg.norm(pts - pts[idx[-1]], axis=1)
        dist = np.minimum(dist, d)
        idx.append(int(np.argmax(dist)))
    return points[idx], np.array(idx)


def fps_rad_idx(points: np.ndarray, radius: float, rng=None,
                native: bool = True):
    """Radius-stop FPS with a random start drawn from `rng` (a
    np.random.RandomState; the global numpy stream when None): add the
    farthest point until every point is within `radius` of the set;
    returns (points[idx], idx)."""
    rng = rng or np.random
    start = rng.randint(len(points))
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if native:
        out = np.empty(len(pts), np.int64)
        got = _lib().fps_rad_indices(pts.ctypes.data_as(_P_F32), len(pts),
                                     float(radius), start, len(pts),
                                     out.ctypes.data_as(_P_I64))
        idx = out[:got]
        return points[idx], idx
    idx = [start]
    dist = np.linalg.norm(pts - pts[start], axis=1)
    while dist.max() > radius:
        nxt = int(dist.argmax())
        idx.append(nxt)
        dist = np.minimum(dist, np.linalg.norm(pts - pts[nxt], axis=1))
    return points[idx], np.array(idx)
