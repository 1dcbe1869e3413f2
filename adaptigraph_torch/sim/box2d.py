"""2-D quasi-static box pushing side task: the port of
adaptigraph_tpu/sim/box2d.py (numpy, the same arithmetic).

A rigid rectangular box with a random size and centre of mass is pushed
by a point pusher from one of 4 directions. The dynamics are
quasi-static: a push displacement at a contact point moves the box by its
component along the contact normal and turns it about the centre of
friction, by a gain that grows with the contact's lever arm. Episodes are
saved as npz state (and optionally image) sequences; `render` needs cv2,
imported when it is called.
"""

from __future__ import annotations

import os

import numpy as np


class BoxSim:
    def __init__(self, box_size=(1.0, 0.6), com_offset=(0.0, 0.0), mu: float = 0.3):
        self.w, self.h = box_size
        self.com = np.asarray(com_offset, np.float64)
        self.mu = mu
        self.pose = np.zeros(3)  # x, y, theta

    # -- geometry --

    def _world_to_box(self, p):
        c, s = np.cos(self.pose[2]), np.sin(self.pose[2])
        r = np.array([[c, s], [-s, c]])
        return r @ (np.asarray(p) - self.pose[:2])

    def _box_to_world(self, p):
        c, s = np.cos(self.pose[2]), np.sin(self.pose[2])
        r = np.array([[c, -s], [s, c]])
        return r @ np.asarray(p) + self.pose[:2]

    def sdf(self, p_world):
        q = np.abs(self._world_to_box(p_world)) - np.array([self.w / 2, self.h / 2])
        outside = np.maximum(q, 0.0)
        return np.linalg.norm(outside) + min(max(q[0], q[1]), 0.0)

    def corners(self):
        half = np.array([[self.w / 2, self.h / 2], [-self.w / 2, self.h / 2],
                         [-self.w / 2, -self.h / 2], [self.w / 2, -self.h / 2]])
        return np.stack([self._box_to_world(c) for c in half])

    # -- quasi-static push step --

    def push(self, contact_world, delta_world, rot_gain: float = 0.8):
        """Apply a pusher displacement at a contact point. Only acts when
        the contact penetrates the box boundary."""
        if self.sdf(contact_world) > 1e-9:
            return False
        c_box = self._world_to_box(contact_world)
        # contact normal: nearest face in the box frame
        dx = self.w / 2 - abs(c_box[0])
        dy = self.h / 2 - abs(c_box[1])
        if dx < dy:
            n_box = np.array([np.sign(c_box[0]), 0.0])
        else:
            n_box = np.array([0.0, np.sign(c_box[1])])
        cth, sth = np.cos(self.pose[2]), np.sin(self.pose[2])
        n_world = np.array([[cth, -sth], [sth, cth]]) @ n_box
        # normal component of the push (into the face) moves the box
        push_n = n_world * min(0.0, np.dot(delta_world, n_world))
        # translation
        self.pose[:2] += push_n
        # rotation about the center of friction (com): lever arm torque
        lever = c_box - self.com
        tau = lever[0] * (push_n @ np.array([-sth, cth])) - \
            lever[1] * (push_n @ np.array([cth, sth]))
        inertia = (self.w**2 + self.h**2) / 12.0
        self.pose[2] += rot_gain * tau / (inertia + np.dot(lever, lever))
        return True

    def render(self, size: int = 128, extent: float = 3.0):
        img = np.full((size, size), 255, np.uint8)
        corners = self.corners()
        import cv2

        pts = ((corners / extent * 0.5 + 0.5) * size).astype(np.int32)
        pts[:, 1] = size - 1 - pts[:, 1]
        cv2.fillPoly(img, [pts], 128)
        return img


def gen_box_episode(rng: np.random.RandomState, n_pushes: int = 4,
                    steps_per_push: int = 40, render: bool = False):
    """One episode: random box, pushes from 4 directions
    (data_gen_box.py:14-110). Returns dict(states (T, 3), pushes, imgs?)."""
    size = (rng.uniform(0.6, 1.4), rng.uniform(0.4, 1.0))
    com = (rng.uniform(-0.2, 0.2) * size[0], rng.uniform(-0.2, 0.2) * size[1])
    sim = BoxSim(size, com)
    states, imgs, pushes = [sim.pose.copy()], [], []
    if render:
        imgs.append(sim.render())
    for _ in range(n_pushes):
        direction = rng.randint(4)  # +x, -x, +y, -y
        n = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]][direction], np.float64)
        # start outside the box along -n with random lateral offset
        lateral = np.array([-n[1], n[0]])
        start = sim.pose[:2] - n * 2.0 + lateral * rng.uniform(-0.4, 0.4)
        step = n * (3.0 / steps_per_push)
        p = start.copy()
        for _ in range(steps_per_push):
            p = p + step
            sim.push(p, step)
        pushes.append(np.r_[start, n])
        states.append(sim.pose.copy())
        if render:
            imgs.append(sim.render())
    out = {"states": np.stack(states), "pushes": np.stack(pushes),
           "box_size": np.asarray(size), "com": np.asarray(com)}
    if render:
        out["imgs"] = np.stack(imgs)
    return out


def gen_box_data(out_dir: str, n_episodes: int = 10, seed: int = 0, render: bool = False):
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_episodes):
        ep = gen_box_episode(np.random.RandomState(seed + i), render=render)
        np.savez(os.path.join(out_dir, f"box_{i:04}.npz"), **ep)
    return n_episodes


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default="dump/box_data")
    ap.add_argument("--n-episodes", type=int, default=10)
    ap.add_argument("--render", action="store_true")
    args = ap.parse_args()
    gen_box_data(args.out, args.n_episodes, render=args.render)
