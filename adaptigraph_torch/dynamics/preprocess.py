"""Offline preprocessing helpers: the numpy functions of
adaptigraph_tpu/dynamics/preprocess.py.

  * eef raw 14-dim shape states -> world keypoints via quaternion rotation
    and per-tool offsets from the config (process_eef);
  * per-episode physics labels (extract_physics): rope 'stiffness',
    granular 'granular_scale', cloth 'sf';
  * push-distance frame pairing (extract_push): for every frame, walk
    backward and forward collecting frames whose eef xz displacement
    reaches dist_thresh until n_his + n_future indices exist (padded at
    the ends);
  * sanitize_positions: escaped particles frozen in place.

`preprocess()`, which reads h5 episodes and writes frame_pairs/,
positions.pkl, phys_range.txt and metadata.txt, comes with the
data-generation slice.
"""

from __future__ import annotations

import numpy as np

from adaptigraph_torch.sim.episode_io import load_property_params

_PHYS_KEYS = {"rope": ["stiffness"], "granular": ["granular_scale"],
              "cloth": ["sf"]}


def quat_to_mat_np(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def process_eef(eef_states: np.ndarray, eef_dataset) -> np.ndarray:
    """(T, N_eef_raw, 14) -> (T, max_neef, 3) world keypoints."""
    t = eef_states.shape[0]
    if eef_states.ndim == 2:
        eef_states = eef_states.reshape(t, 1, 14)
    offsets = np.asarray(eef_dataset["pos"], dtype=np.float64)
    n_eef = len(offsets)
    if n_eef != int(eef_dataset["max_neef"]):
        raise ValueError("number of eef offsets mismatch")
    out = np.zeros((t, n_eef, 3))
    for i in range(t):
        for j in range(n_eef):
            raw_j = min(j, eef_states.shape[1] - 1)  # granular reuses the last link
            st = eef_states[i][raw_j]
            rot = quat_to_mat_np(st[6:10])
            out[i, j] = st[0:3] + rot @ offsets[j]
    return out


def extract_physics(epi_dir: str, obj: str) -> np.ndarray:
    props = load_property_params(epi_dir)
    return np.array([props[k] for k in _PHYS_KEYS[obj]], dtype=np.float32)


def extract_push(eef: np.ndarray, dist_thresh: float, n_his: int,
                 n_future: int, n_frames: int):
    """Frame-pair table for one push; eef: (T, N_eef, 3). Returns
    ((T, n_his+n_future) indices offset by n_frames, count)."""
    t_total = eef.shape[0]
    xz = eef[:, 0][:, [0, 2]]
    rows = []
    for fj in range(t_total):
        # backward: n_his anchors (current frame first, then history)
        traj = [fj]
        cur = xz[fj]
        fi = fj
        while fi >= 0 and len(traj) < n_his:
            if np.linalg.norm(cur - xz[fi]) >= dist_thresh:
                traj.append(fi)
                cur = xz[fi]
            fi -= 1
        traj = traj + [traj[-1]] * (n_his - len(traj))
        traj = traj[::-1]
        # forward: n_future targets
        cur = xz[fj]
        fi = fj
        while fi < t_total and len(traj) < n_his + n_future:
            if np.linalg.norm(cur - xz[fi]) >= dist_thresh:
                traj.append(fi)
                cur = xz[fi]
            fi += 1
        traj = traj + [traj[-1]] * (n_his + n_future - len(traj))
        rows.append(traj)
    return np.array(rows, dtype=np.int64) + n_frames, t_total


def sanitize_positions(pos, bound: float = 20.0):
    """Freeze escaped particles at their last in-bounds position.

    A bad contact substep can eject a single particle to enormous (finite)
    coordinates; one such point poisons FPS sampling and the training loss.
    pos: (T, N, 3). Out-of-bounds samples forward-fill from the most recent
    in-bounds frame (first-frame escapees back-fill from the first good)."""
    pos = np.asarray(pos)
    bad = np.abs(pos).max(axis=-1) > bound  # (T, N)
    if not bad.any():
        return pos
    out = pos.copy()
    t = pos.shape[0]
    for n in np.unique(np.nonzero(bad)[1]):
        good = np.nonzero(~bad[:, n])[0]
        if len(good) == 0:
            out[:, n] = 0.0
            continue
        last = good[0]
        for fi in range(t):
            if bad[fi, n]:
                out[fi, n] = out[last, n]
            else:
                last = fi
    return out
