"""Camera rig matching the reference's multi-view setup: a numpy copy of
adaptigraph_tpu/sim/cameras.py, with the same outputs bit for bit.

Reference: src/sim/sim_env/cameras.py — 4 cameras on a circle (cam_dis=6,
height=10) at 45 deg elevation, yaw {45, 135, 225, 315} deg; plus a top view.
Intrinsics follow the FleX projection (vertical fov = pi/4,
PyFleX/bindings/pyflex.cpp:1266): fx = cot(fov/2) * cx. Extrinsics are the
GL view matrix (world -> camera, y up, -z forward), the same convention the
reference saves from pyflex.get_viewMatrix and consumes by flipping y/z
before pinhole projection (src/dynamics/rollout/graph.py:87-97).
"""

from __future__ import annotations

import numpy as np


def _look_dir(yaw: float, pitch: float) -> np.ndarray:
    """FleX camera forward vector from (yaw, pitch) in radians."""
    return np.array(
        [-np.sin(yaw) * np.cos(pitch), np.sin(pitch), -np.cos(yaw) * np.cos(pitch)],
        dtype=np.float64,
    )


def view_matrix(cam_pos: np.ndarray, cam_angle: np.ndarray) -> np.ndarray:
    """GL lookAt view matrix from FleX camPos + camAngle (yaw, pitch, roll)."""
    fwd = _look_dir(cam_angle[0], cam_angle[1])
    up = np.array([0.0, 1.0, 0.0])
    z = -fwd / np.linalg.norm(fwd)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = x, y, z
    view[:3, 3] = -view[:3, :3] @ np.asarray(cam_pos, dtype=np.float64)
    return view.astype(np.float32)


class CameraRig:
    """The 4-camera capture rig + single-view rendering camera."""

    def __init__(self, width: int = 720, height: int = 720, cam_dis: float = 6.0,
                 cam_height: float = 10.0):
        self.width = width
        self.height = height
        self.cam_dis = cam_dis
        self.cam_height = cam_height
        self.fov = np.pi / 4.0

    def intrinsics(self) -> np.ndarray:
        cx, cy = self.width / 2.0, self.height / 2.0
        f = 1.0 / np.tan(self.fov / 2.0)
        return np.array([f * cx, f * cy, cx, cy], dtype=np.float32)

    def single_view(self, camera_view: int):
        """(camPos, camAngle) for the live-rendering camera (cameras.py:17-36)."""
        if camera_view == 0:
            return (np.array([0.0, self.cam_height + 10.0, 0.0]),
                    np.array([0.0, -np.deg2rad(90.0), 0.0]))
        degs = np.array([0.0, 90.0, 180.0, 270.0]) + 45.0
        xs = np.array([self.cam_dis, self.cam_dis, -self.cam_dis, -self.cam_dis])
        zs = np.array([self.cam_dis, -self.cam_dis, -self.cam_dis, self.cam_dis])
        i = camera_view - 1
        pos = np.array([xs[i], self.cam_height, zs[i]])
        ang = np.array([np.deg2rad(degs[i]), -np.deg2rad(45.0), 0.0])
        return pos, ang

    def multiview(self):
        """4 capture cameras; returns (cam_pos (4,3), cam_angle (4,3),
        intrinsics (4,4), extrinsics (4,4,4))."""
        degs = np.deg2rad(np.array([0.0, 90.0, 180.0, 270.0]) + 45.0)
        xs = np.array([self.cam_dis, self.cam_dis, -self.cam_dis, -self.cam_dis])
        zs = np.array([self.cam_dis, -self.cam_dis, -self.cam_dis, self.cam_dis])
        pos = np.stack([xs, np.full(4, self.cam_height), zs], axis=1)
        ang = np.stack([degs, np.full(4, -np.deg2rad(45.0)), np.zeros(4)], axis=1)
        intr = np.tile(self.intrinsics()[None], (4, 1))
        extr = np.stack([view_matrix(pos[i], ang[i]) for i in range(4)], axis=0)
        return pos.astype(np.float32), ang.astype(np.float32), intr, extr
