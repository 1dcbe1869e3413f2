"""Every input of a run: the model's weights, the planning target and the
training episodes, made from the run's seed on the run's device, and the
object's point cloud as the planner perceives it, made from the
configuration's own scene seed on the CPU. Nothing here reads the program
under test; the same tensors go to the program and to the reference.

Each kind of input draws from its own torch.Generator, seeded from its
seed and a fixed tag, so that adding draws to one kind moves no other.
"""

from __future__ import annotations

import math

import torch

TAGS = {"weights": 1, "object": 2, "target": 3, "episodes": 4, "noise": 5,
        "rows": 6, "graphs": 7, "batches": 8, "warmup": 9}


def seed_for(seed: int, kind: str) -> int:
    """The seed of one kind of input of run `seed`."""
    return (int(seed) * 1_000_003 + TAGS[kind] * 7_919) % (2 ** 63 - 1)


def generator(seed: int, kind: str, device) -> torch.Generator:
    """A generator on `device` for one kind of input of run `seed`."""
    return torch.Generator(device=device).manual_seed(seed_for(seed, kind))


def weights(shapes: dict, spec: dict, seed: int, device) -> dict:
    """A state_dict of random weights: each weight normal with std
    1/sqrt(fan_in) truncated at 2 std, each bias uniform within
    spec['bias'] / sqrt(fan_in), the motion head's last layer scaled by
    spec['head_scale'] (so that a push step moves the object by about a
    push length, as a trained model does); drawn in two calls."""
    g = generator(seed, "weights", device)
    n_w = sum(i * o for i, o in shapes.values())
    n_b = sum(o for _, o in shapes.values())
    w = torch.randn(n_w, generator=g, device=device).clamp_(-2.0, 2.0)
    bias = torch.rand(n_b, generator=g, device=device).mul_(2).sub_(1)
    out, iw, ib = {}, 0, 0
    for name, (i, o) in shapes.items():
        scale = 1.0 / math.sqrt(i)
        if name == spec["head"]:
            scale *= float(spec["head_scale"])
        out[name + ".weight"] = w[iw:iw + i * o].view(o, i) * scale
        out[name + ".bias"] = bias[ib:ib + o] * (float(spec["bias"]) * scale)
        iw, ib = iw + i * o, ib + o
    return out


def _rope(g, n: int, spec: dict, device):
    """A rope of n points: a smooth random curve of spec['length'] in the
    x-z plane, its heading bending as a sum of three sines of amplitude up
    to spec['bend'], the points uniform along it and within a tube of
    spec['radius'], lying on the table."""
    u = torch.rand((6 + 3 * n,), generator=g, device=device)
    amp = (u[:3] * 2 - 1) * spec["bend"]
    phase = u[3:6] * 2 * math.pi
    s_grid = torch.linspace(0, 1, 512, device=device)
    heading = (amp[:, None] * torch.sin(
        math.pi * torch.arange(1, 4, device=device)[:, None] * s_grid
        + phase[:, None])).sum(0)
    seg = spec["length"] / 511
    step = torch.stack([torch.cos(heading), torch.sin(heading)], -1) * seg
    line = torch.cat([torch.zeros((1, 2), device=device),
                      torch.cumsum(step[:-1], 0)])
    line = line - line.mean(0)
    pos = u[6:6 + n] * 511
    i0 = pos.floor().long().clamp(max=510)
    f = (pos - i0)[:, None]
    centre = line[i0] * (1 - f) + line[i0 + 1] * f
    ang = u[6 + n:6 + 2 * n] * 2 * math.pi
    rad = spec["radius"] * torch.sqrt(u[6 + 2 * n:6 + 3 * n])
    tangent = step[i0] / seg
    normal = torch.stack([-tangent[:, 1], tangent[:, 0]], -1)
    xz = centre + normal * (rad * torch.cos(ang))[:, None]
    y = spec["radius"] + rad * torch.sin(ang)
    return torch.stack([xz[:, 0], y, xz[:, 1]], -1)


def _heap(g, n: int, spec: dict, device):
    """A granular heap of n points: uniform over a disc of spec['radius']
    in x-z, each point's height uniform under a paraboloid of
    spec['height']."""
    u = torch.rand((3, n), generator=g, device=device)
    r = spec["radius"] * torch.sqrt(u[0])
    a = u[1] * 2 * math.pi
    h = spec["height"] * (1 - (r / spec["radius"]) ** 2) * u[2] + 0.05
    return torch.stack([r * torch.cos(a), h, r * torch.sin(a)], -1)


def cloud(g, n: int, spec: dict, device):
    """The object's points, centred at the origin of x-z."""
    return (_rope if spec["kind"] == "rope" else _heap)(g, n, spec, device)


def place(g, pts, spec: dict):
    """pts turned about y by a draw within +-spec['turn'] and moved to a
    draw within spec['centre_x'] and spec['centre_z']."""
    u = torch.rand((3,), generator=g, device=pts.device)
    a = (u[0] * 2 - 1) * spec["turn"]
    (x0, x1), (z0, z1) = spec["centre_x"], spec["centre_z"]
    cx = x0 + u[1] * (x1 - x0)
    cz = z0 + u[2] * (z1 - z0)
    c, s = torch.cos(a), torch.sin(a)
    x, z = pts[:, 0], pts[:, 2]
    return torch.stack([c * x - s * z + cx, pts[:, 1], s * x + c * z + cz], -1)


def fps_radius(points, radius: float, max_n: int, start: int):
    """Farthest-point sampling of one cloud from `start` until every point
    is within `radius` of the picks or max_n are picked (the perception's
    down-sampling): the picked points."""
    d = torch.linalg.vector_norm(points - points[start], dim=-1)
    picks = [start]
    while len(picks) < max_n:
        nxt = int(torch.argmax(d))
        if float(d[nxt]) <= radius:
            break
        picks.append(nxt)
        d = torch.minimum(d, torch.linalg.vector_norm(points - points[nxt],
                                                      dim=-1))
    return points[torch.tensor(picks, device=points.device)]


def perceived_points(scene_seed: int, scene: dict, task: dict):
    """The points the perception keeps of scene `scene_seed`: the object's
    cloud placed on the table and down-sampled at the task's fps_radius,
    its cloud, placement and FPS start drawn on the CPU from the scene
    seed, so that every device sees the same scene."""
    cpu = torch.device("cpu")
    g = generator(scene_seed, "object", cpu)
    dense = place(g, cloud(g, int(scene["points"]), scene, cpu), scene)
    start = int(torch.randint(dense.shape[0], (1,), generator=g))
    return fps_radius(dense, float(task["fps_radius"]),
                      int(task["max_nobj"]), start)


def planning_state(scene: dict, task: dict, device):
    """(state (max_nobj, 3), mask (max_nobj,)) on `device`: the points of
    the configuration's own scene (scene['scene_seed']), padded with zero
    rows. The run's seed does not enter: the rollout's work follows the
    perceived count, which must be scene['perceived']."""
    pts = perceived_points(int(scene["scene_seed"]), scene, task)
    if pts.shape[0] != int(scene["perceived"]):
        raise ValueError(f"scene seed {scene['scene_seed']} perceives "
                         f"{pts.shape[0]} points; the configuration states "
                         f"{scene['perceived']}")
    n_max = int(task["max_nobj"])
    state = torch.zeros((n_max, 3))
    state[:pts.shape[0]] = pts
    mask = torch.arange(n_max) < pts.shape[0]
    return state.to(device), mask.to(device)


def planning_target(seed: int, state, mask, task: dict, spec: dict, device):
    """The target: for a cloud target, the perceived points turned about y
    by a draw within +-spec['turn'] about their centre and moved by draws
    within +-spec['shift'] in x and z; for a box target, the task's box
    scaled to sim units, [[xmin, xmax], [zmin, zmax]]."""
    if task["target_type"] == "box":
        return (torch.tensor(task["target"], dtype=torch.float32,
                             device=device).reshape(2, 2)
                * float(task["sim_real_ratio"]))
    g = generator(seed, "target", device)
    pts = state[mask]
    u = torch.rand((3,), generator=g, device=device) * 2 - 1
    a = u[0] * spec["turn"]
    c, s = torch.cos(a), torch.sin(a)
    mid = pts.mean(0)
    x, z = pts[:, 0] - mid[0], pts[:, 2] - mid[2]
    return torch.stack([c * x - s * z + mid[0] + u[1] * spec["shift"],
                        pts[:, 1],
                        s * x + c * z + mid[2] + u[2] * spec["shift"]], -1)


def episodes(seed: int, spec: dict, n_eef: int, device):
    """Training episodes, made on the device: spec['count'] episodes of
    spec['frames'] frames of spec['points'] object points and n_eef pusher
    points. Each episode's object is a fresh cloud; its pusher sweeps a
    straight line through the object's centre at spec['speed'] a frame,
    and every point the pusher's path has passed within spec['reach'] is
    carried along with it, fading with distance, so the frames move as a
    push moves them. Returns (obj (E, T, N, 3), eef (E, T, n_eef, 3))."""
    g = generator(seed, "episodes", device)
    e, t, n = int(spec["count"]), int(spec["frames"]), int(spec["points"])
    objs, eefs = [], []
    for _ in range(e):
        pts = place(g, cloud(g, n, spec["object"], device), spec["object"])
        u = torch.rand((2,), generator=g, device=device)
        a = u[0] * 2 * math.pi
        d = torch.stack([torch.cos(a), torch.sin(a)])
        mid = pts[:, [0, 2]].mean(0)
        travel = torch.arange(t, device=device) * spec["speed"]
        start = mid - d * spec["approach"]
        track = start + travel[:, None] * d  # (T, 2)
        along = (pts[:, [0, 2]] - start) @ d  # (N,)
        across = (pts[:, [0, 2]] - start) @ torch.stack([-d[1], d[0]])
        weight = torch.exp(-(across / spec["reach"]) ** 2)
        moved = torch.relu(travel[:, None] - along[None]) * weight[None]
        frame = pts[None].expand(t, -1, -1).clone()
        frame[..., 0] += moved * d[0]
        frame[..., 2] += moved * d[1]
        offs = (torch.arange(n_eef, device=device) - (n_eef - 1) / 2) * 0.25
        side = torch.stack([-d[1], d[0]])
        eef_xz = track[:, None] + offs[None, :, None] * side
        eef = torch.stack([eef_xz[..., 0], torch.full_like(eef_xz[..., 0],
                           float(u[1]) * 0.1 + 0.1), eef_xz[..., 1]], -1)
        objs.append(frame)
        eefs.append(eef)
    return torch.stack(objs), torch.stack(eefs)
