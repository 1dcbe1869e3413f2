"""Host-side farthest point sampling, for the rollout evaluator's start
graph: the port of adaptigraph_tpu/utils/host_fps.py.

The numpy form of the JAX package's functions: greedy max-min over float32
distances, numpy-argmax first-index tie-breaking, and for the radius
variant a random start drawn from the caller's RandomState. The JAX
package runs the same loop natively (`libfps.so`), held bit-identical to
this numpy form by its own tests; the port's native build is not written
yet.
"""

from __future__ import annotations

import numpy as np


def fps_with_idx(points: np.ndarray, n: int):
    """Greedy FPS starting at index 0; returns (points[idx], idx)."""
    if n >= len(points):
        return points, np.arange(len(points))
    pts = np.ascontiguousarray(points, dtype=np.float32)
    idx = [0]
    dist = np.full(len(pts), np.inf, np.float32)
    for _ in range(1, n):
        d = np.linalg.norm(pts - pts[idx[-1]], axis=1)
        dist = np.minimum(dist, d)
        idx.append(int(np.argmax(dist)))
    return points[idx], np.array(idx)


def fps_rad_idx(points: np.ndarray, radius: float, rng=None):
    """Radius-stop FPS with a random start drawn from `rng` (a
    np.random.RandomState; the global numpy stream when None); returns
    (points[idx], idx)."""
    rng = rng or np.random
    start = rng.randint(len(points))
    pts = np.ascontiguousarray(points, dtype=np.float32)
    idx = [start]
    dist = np.linalg.norm(pts - pts[start], axis=1)
    while dist.max() > radius:
        nxt = int(dist.argmax())
        idx.append(nxt)
        dist = np.minimum(dist, np.linalg.norm(pts - pts[nxt], axis=1))
    return points[idx], np.array(idx)
