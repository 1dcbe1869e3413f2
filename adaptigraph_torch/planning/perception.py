"""Perception: multi-camera RGB-D -> object point cloud -> graph state. The
port of adaptigraph_tpu/planning/perception.py.

Depth back-projection, a workspace crop, voxel downsampling, statistical
outlier removal, a height filter and FPS, all host numpy, as in the JAX
package: on the same frames and the same RandomState the port gives the
same arrays. The segmentation stage is a pluggable `segmenter` callable:
`depth_mask_segmenter` keeps whatever stands above the table, which on a
rendered frame without the tool and the arm (SimPlanEnv.get_obs) is the
object.

The outlier pass works on at most 4,000 points (a RandomState(0) subset
beyond that), with their full distance matrix: at 4,000 points a
(4000, 4000, 3) float32 block of differences (192 MB) and a sort of each
row, on the host.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from adaptigraph_torch.utils.host_fps import fps_rad_idx, fps_with_idx

OUTLIER_CAP = 4000  # the most points the outlier pass takes


def depth_to_points(depth_m: np.ndarray, intr: np.ndarray, extr: np.ndarray,
                    mask: np.ndarray | None = None) -> np.ndarray:
    """Back-project a depth map to world points.

    depth_m: (H, W) metric depth (0 = invalid); intr: [fx, fy, cx, cy];
    extr: (4, 4) GL view matrix (world->cam). Inverts the renderer's
    projection (sim.render): x_cam = (u-cx)/fx * z, y_cam = -(v-cy)/fy * z,
    z_cam = -z.
    """
    h, w = depth_m.shape
    fx, fy, cx, cy = intr
    vv, uu = np.mgrid[0:h, 0:w]
    z = depth_m
    valid = z > 0
    if mask is not None:
        valid &= mask.astype(bool)
    x = (uu + 0.5 - cx) / fx * z
    y = -(vv + 0.5 - cy) / fy * z
    pts_cam = np.stack([x, y, -z], axis=-1)[valid]  # GL camera frame
    # world = R^T (cam - t)
    r = extr[:3, :3]
    t = extr[:3, 3]
    return (pts_cam - t) @ r


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """The mean of the points in each occupied voxel, float32 (open3d's
    voxel_down_sample)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(np.float32)


def remove_statistical_outliers(points: np.ndarray, k: int = 20,
                                std_ratio: float = 2.0, iterations: int = 2):
    """Iterative statistical outlier removal: drop the points whose mean
    distance to their k nearest neighbours exceeds the mean of that over
    all points by std_ratio standard deviations."""
    pts = points
    for _ in range(iterations):
        if len(pts) <= k + 1:
            break
        d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        knn = np.sort(d, axis=1)[:, :k].mean(axis=1)
        keep = knn < knn.mean() + std_ratio * knn.std()
        pts = pts[keep]
    return pts


def depth_mask_segmenter(color: np.ndarray, depth_m: np.ndarray,
                         table_height: float, intr, extr) -> np.ndarray:
    """The sim segmenter: pixels whose world point sits more than 0.02
    above the table surface (and that hit something)."""
    h, w = depth_m.shape
    fx, fy, cx, cy = intr
    vv, uu = np.mgrid[0:h, 0:w]
    z = depth_m
    x = (uu + 0.5 - cx) / fx * z
    y = -(vv + 0.5 - cy) / fy * z
    cam = np.stack([x, y, -z], axis=-1)
    r, t = extr[:3, :3], extr[:3, 3]
    world_y = (cam - t) @ r[:, 1]
    return (z > 0) & (world_y > table_height + 0.02)


def real_points_to_sim(points_m: np.ndarray,
                       sim_real_ratio: float) -> np.ndarray:
    """Real table-frame points (meters, y-up, as the board calibration
    gives them) -> sim units: a scale by sim_real_ratio. The plan frame's z
    negation is flex_to_plan, which the caller applies as for sim states."""
    return np.asarray(points_m, np.float32) * float(sim_real_ratio)


def capture_goal(env, pm: "PerceptionModule", out_path: str | None = None):
    """Capture a target point cloud from live frames: observe every camera,
    fuse the segmented tabletop cloud, and save it to `out_path` (.npy)
    for plan()'s pcd target mode.

    Returns the (M, 3) cloud in the env's own frame and units: the flex
    frame in sim units for SimPlanEnv, table meters for a real rig.
    plan() multiplies a loaded target by sim_real_ratio and does not
    negate its z, so a cloud captured from SimPlanEnv must be mirrored to
    the plan frame and divided by the ratio before plan() reads it (kept
    as the JAX package has it; see planning/plan.py)."""
    colors, depths = env.get_obs()
    pts = pm.get_tabletop_points(colors, depths, env.cam_intr, env.cam_extr)
    if out_path:
        base = os.path.dirname(out_path)
        if base:
            os.makedirs(base, exist_ok=True)
        np.save(out_path, pts)
    return pts


class PerceptionModule:
    """The fused tabletop cloud and the graph state drawn from it."""

    def __init__(self, task_config, segmenter: Callable | None = None,
                 table_height: float = 0.5, voxel: float = 0.02,
                 workspace=((-3.5, 3.5), (0.0, 3.0), (-4.5, 4.5))):
        self.task_config = task_config
        self.segmenter = segmenter or depth_mask_segmenter
        self.table_height = table_height
        self.voxel = voxel
        self.workspace = np.asarray(workspace, np.float64)
        self.fps_radius = float(task_config["fps_radius"])
        self.max_nobj = int(task_config["max_nobj"])
        self.k_filter = float(task_config.get("k_filter", 1.0))

    def get_tabletop_points(self, colors, depths, intrs, extrs) -> np.ndarray:
        """The fused, segmented object cloud from n cameras.

        colors: (n, H, W, 3); depths: (n, H, W) metric; intrs (n, 4);
        extrs (n, 4, 4). Returns (M, 3) float32 world points.
        """
        clouds = []
        for c, d, k, e in zip(colors, depths, intrs, extrs):
            m = self.segmenter(c, d, self.table_height, k, e)
            clouds.append(depth_to_points(d, k, e, mask=m))
        pts = np.concatenate(clouds, axis=0) if clouds else np.zeros((0, 3))
        ws = self.workspace  # the workspace crop
        keep = np.all((pts >= ws[:, 0]) & (pts <= ws[:, 1]), axis=1)
        pts = pts[keep]
        pts = voxel_downsample(pts, self.voxel)
        if len(pts) > OUTLIER_CAP:
            pts = pts[np.random.RandomState(0).choice(len(pts), OUTLIER_CAP,
                                                      replace=False)]
        pts = remove_statistical_outliers(pts)
        # height filter: drop the points above the k_filter quantile of y
        if len(pts) and self.k_filter < 1.0:
            y = pts[:, 1]
            cut = np.quantile(y, self.k_filter)
            pts = pts[y <= cut + 1e-6]
        return pts.astype(np.float32)

    def get_state_cur(self, colors, depths, intrs, extrs, rng=None):
        """The object's graph state: the fused cloud's radius-FPS keypoints
        (the start drawn from `rng`, the global numpy stream when None),
        capped at max_nobj by FPS. Returns (state (k, 3), cloud)."""
        rng = rng or np.random
        pts = self.get_tabletop_points(colors, depths, intrs, extrs)
        if len(pts) == 0:
            return np.zeros((0, 3), np.float32), pts
        _, idx = fps_rad_idx(pts, self.fps_radius, rng)
        if len(idx) > self.max_nobj:
            _, sub = fps_with_idx(pts[idx], self.max_nobj)
            idx = idx[sub]
        return pts[idx].astype(np.float32), pts
