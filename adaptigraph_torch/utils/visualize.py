"""Visualization: keypoint/edge overlays on camera frames + video
assembly; the port of adaptigraph_tpu/utils/visualize.py (numpy, with cv2
imported inside the functions that draw: no card path imports it).

As the reference's overlay/video utilities (src/planning/plan_utils.py
:104-281 visualize_img; src/dynamics/rollout/graph.py:44-230
visualize_graph; moviepy_merge_video src/dynamics/utils.py:97-103 — here
cv2.VideoWriter since moviepy isn't available).

Projection convention matches the saved camera params: extr is the GL view
matrix; flip y/z after transforming, then pinhole-project
(rollout/graph.py:87-97).
"""

from __future__ import annotations

import os

import numpy as np


def project_points(points, intr, extr):
    """(N, 3) world -> (N, 2) pixel coords (+ depth) using the saved
    GL-convention extrinsics."""
    pts = np.concatenate([points, np.ones((len(points), 1))], axis=1) @ extr.T
    pts[:, 1] *= -1
    pts[:, 2] *= -1
    fx, fy, cx, cy = intr
    z = np.maximum(pts[:, 2], 1e-6)
    u = pts[:, 0] * fx / z + cx
    v = pts[:, 1] * fy / z + cy
    return np.stack([u, v], axis=1), z


def overlay_graph(img, kp, intr, extr, edges=None, gt_kp=None, eef_kp=None,
                  point_size: int = 4, edge_size: int = 1):
    """Draw predicted keypoints (red), ground truth (green), eef (blue), and
    graph edges onto an RGB uint8 image."""
    import cv2

    out = np.ascontiguousarray(img.copy())

    def draw_points(points, color):
        uv, _ = project_points(points, intr, extr)
        for u, v in uv:
            if 0 <= u < out.shape[1] and 0 <= v < out.shape[0]:
                cv2.circle(out, (int(u), int(v)), point_size, color, -1)
        return uv

    uv = draw_points(kp, (255, 0, 0))
    if edges is not None:
        recv, send, valid = edges
        for r, s, ok in zip(recv, send, valid):
            if not ok or r >= len(uv) or s >= len(uv):
                continue
            p1, p2 = uv[int(r)], uv[int(s)]
            cv2.line(out, (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1])),
                     (0, 0, 0), edge_size)
    if gt_kp is not None:
        draw_points(gt_kp, (0, 200, 0))
    if eef_kp is not None:
        draw_points(eef_kp, (0, 0, 255))
    return out


# the reference's overlay palette (plan_utils.py:194-197, BGR-ish RGB)
_COLOR_START = (202, 63, 41)
_COLOR_ACTION = (27, 74, 242)
_COLOR_PRED = (237, 158, 49)
_COLOR_TARGET = (26, 130, 81)


def plan_to_world(points, units: str = "sim", sim_real_ratio: float = 10.0):
    """Planning frame (x, y-up, z negated; sim units) -> the frame the saved
    camera extrinsics live in: flex world for sim cameras, table meters for
    real rigs (plan_utils.py:118-126's inverse mapping)."""
    pts = np.asarray(points, np.float64).copy()
    pts[..., 2] *= -1  # undo the planning-frame z flip
    if units == "real":
        pts = pts / sim_real_ratio
    return pts


def overlay_plan(img, state_init, state_pred, action, intr, extr,
                 target_state=None, target_box=None, push_length: float = 0.1,
                 adj_thresh: float | None = None, topk: int = 10,
                 units: str = "sim", sim_real_ratio: float = 10.0,
                 state_after=None):
    """Planning overlay at reference richness (plan_utils.py:104-281):
    initial state dots+edges (red), one action arrow PER REPEAT (blue),
    target pcd dots / filled target-box outline (green), predicted state
    dots+edges (orange), 50% blended over the pre-prediction layer.

    States/targets/actions are in the PLANNING frame (sim units, z flipped);
    `units`/`sim_real_ratio` select the camera frame conversion."""
    import cv2

    out = np.ascontiguousarray(img.copy())

    def proj(points):
        uv, _ = project_points(plan_to_world(points, units, sim_real_ratio),
                               intr, extr)
        return uv

    def draw_state(canvas, state, color):
        uv = proj(state)
        for u, v in uv:
            if 0 <= u < canvas.shape[1] and 0 <= v < canvas.shape[0]:
                cv2.circle(canvas, (int(u), int(v)), 5, color, -1)
        if adj_thresh is not None and len(state) > 1:
            import torch

            from adaptigraph_torch.ops import build_edges_slotted

            n = len(state)
            e = build_edges_slotted(
                torch.as_tensor(np.asarray(state, np.float32)), adj_thresh,
                torch.ones(n, dtype=torch.bool),
                torch.zeros(n, dtype=torch.bool), topk=topk)
            for r, s, ok in zip(e.receivers.tolist(), e.senders.tolist(),
                                e.valid.tolist()):
                if not ok:
                    continue
                p1, p2 = uv[int(r)], uv[int(s)]
                cv2.line(canvas, (int(p1[0]), int(p1[1])),
                         (int(p2[0]), int(p2[1])), color, 2)
        return canvas

    # starting (or post-execution) state layer
    base_state = state_after if state_after is not None else state_init
    out = draw_state(out, base_state, _COLOR_START)

    # action arrows: one per repeat step (plan_utils.py:216-235)
    xs, zs, theta, length = [float(a) for a in action[:4]]
    rep = max(int(length), 1)
    dx = -push_length * np.cos(theta)
    dz = -push_length * np.sin(theta)
    y = float(np.asarray(base_state)[:, 1].mean()) if len(base_state) else 0.0
    for i in range(rep):
        seg = np.array([[xs + i * dx, y, zs + i * dz],
                        [xs + (i + 1) * dx, y, zs + (i + 1) * dz]])
        uv = proj(seg)
        cv2.arrowedLine(out, (int(uv[0, 0]), int(uv[0, 1])),
                        (int(uv[1, 0]), int(uv[1, 1])), _COLOR_ACTION, 2,
                        tipLength=0.5)

    overlay_base = out.copy()

    if target_state is not None:
        uv = proj(target_state)
        for u, v in uv:
            if 0 <= u < out.shape[1] and 0 <= v < out.shape[0]:
                cv2.circle(out, (int(u), int(v)), 5, _COLOR_TARGET, -1)
    if target_box is not None:
        # four filled border rectangles around [x_min,x_max]x[z_min,z_max]
        # (plan_utils.py:242-262)
        x0, x1, z0, z1 = [float(v) for v in np.asarray(target_box).reshape(-1)]
        e = 0.03
        rects = [
            [[x0 - e, z0 - e], [x0 + e, z0 - e], [x0 + e, z1 + e], [x0 - e, z1 + e]],
            [[x1 - e, z0 - e], [x1 + e, z0 - e], [x1 + e, z1 + e], [x1 - e, z1 + e]],
            [[x0 + e, z0 - e], [x1 - e, z0 - e], [x1 - e, z0 + e], [x0 + e, z0 + e]],
            [[x0 + e, z1 - e], [x1 - e, z1 - e], [x1 - e, z1 + e], [x0 + e, z1 + e]],
        ]
        for rect in rects:
            pts3 = np.array([[rx, 0.0, rz] for rx, rz in rect])
            uv = proj(pts3).astype(np.int32)
            cv2.fillConvexPoly(out, uv, _COLOR_TARGET)

    if state_pred is not None:
        out = draw_state(out, state_pred, _COLOR_PRED)

    return cv2.addWeighted(overlay_base, 0.5, out, 0.5, 0)


def merge_video(image_dir: str, pattern: str, out_path: str, fps: int = 10):
    """Assemble <idx>_<pattern>.jpg frames into an mp4 (cv2 VideoWriter)."""
    import cv2

    files = sorted([f for f in os.listdir(image_dir) if f.endswith(f"{pattern}.jpg")],
                   key=lambda f: int(f.split("_")[0]))
    if not files:
        return False
    first = cv2.imread(os.path.join(image_dir, files[0]))
    h, w = first.shape[:2]
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in files:
        vw.write(cv2.imread(os.path.join(image_dir, f)))
    vw.release()
    return True
