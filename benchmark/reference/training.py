"""The plain reference of AdaptiGraph's dynamics training step (the
reference's src/dynamics/dataset/dataset.py and graph.py, and
src/dynamics/train/train.py, as the JAX package and its port state them):
a window of n_his + n_future frames per sample, two-stage farthest-point
sampling of the objects at the current frame (to max_nobj from a random
start, then stopping once every point is within a random radius), the
state noise and a random rotation about z, the radius graph at a random
radius, the n_future-step unrolled squared error with each prediction fed
back into the history, and one Adam update.

The graph's randoms are drawn here in the order and shapes the trainer
draws them, from a generator seeded as the trainer's is. Farthest-point
distances are rounded as the radius graph's squared distances are, and the
rotation's cosine and sine are taken in float64, so the same draws give the
same graphs.
"""

from __future__ import annotations

import math

import torch

from reference import model as ref_model
from reference.edges import radius_edges, sq_dist

BIG = 1e10


def draws(gen, b, nvalid, max_nobj, fps_range, adj_range, augment, n_his,
          n_nodes, state_noise):
    """One batch's randoms: the two FPS start ranks, the FPS and graph
    radii, and with augment the state noise and the rotation angle."""
    dev = gen.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    u = torch.rand((b, 2), generator=gen, device=dev)
    counts = torch.stack([nvalid.clamp(min=1),
                          nvalid.clamp(max=max_nobj).clamp(min=1)], 1)
    ranks = torch.minimum(torch.floor(u.double() * counts).long(), counts - 1)
    out = {"ranks": ranks, "fps_r": uniform((b,), *fps_range),
           "adj_r": uniform((b,), *adj_range)}
    if augment:
        out["noise"] = uniform((b, n_his, n_nodes, 3), -state_noise,
                               state_noise)
        out["theta"] = uniform((b,), -math.pi, math.pi)
    return out


def _dist(points, centre):
    return torch.sqrt(sq_dist(points - centre[:, None, :]))


def _valid_first(mask):
    return torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)


def fps(points, n_samples, start, valid):
    """Farthest-point sampling of B clouds from `start`: (idx, the
    farthest remaining distance before each pick)."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    dist = torch.where(valid, _dist(points, points[rows, start]),
                       torch.full((), -BIG, device=points.device))
    idx, far = [start], [torch.full((b,), math.inf, device=points.device)]
    for _ in range(n_samples - 1):
        nxt = torch.argmax(dist, dim=1)
        far.append(dist[rows, nxt])
        dist = torch.minimum(dist, torch.where(
            valid, _dist(points, points[rows, nxt]),
            torch.full((), -BIG, device=points.device)))
        idx.append(nxt)
    return torch.stack(idx, 1), torch.stack(far, 1)


def subsample(points, max_n, radius, ranks, valid):
    """The two-stage FPS: (idx into each cloud, keep), kept first."""
    b = points.shape[0]
    nvalid = valid.sum(1)
    start1 = torch.gather(_valid_first(valid), 1, ranks[:, :1])[:, 0]
    idx1, _ = fps(points, max_n, start1, valid)
    sub = torch.gather(points, 1, idx1[:, :, None].expand(b, max_n, 3))
    sub_valid = (torch.gather(valid, 1, idx1)
                 & (torch.arange(max_n, device=points.device)[None]
                    < nvalid.clamp(max=max_n)[:, None]))
    start2 = torch.gather(_valid_first(sub_valid), 1, ranks[:, 1:])[:, 0]
    idx2, far = fps(sub, max_n, start2, sub_valid)
    keep = (far > radius[:, None]) & torch.gather(sub_valid, 1, idx2)
    final = torch.gather(idx1, 1, idx2)
    order = _valid_first(keep)
    final, keep = torch.gather(final, 1, order), torch.gather(keep, 1, order)
    return torch.where(keep, final, final[:, :1]), keep


def _rotate(x, theta):
    c, s = torch.cos(theta.double()).float(), torch.sin(theta.double()).float()
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                       torch.stack([z, z, o], -1)], -2)
    r = rot.reshape((rot.shape[0],) + (1,) * (x.dim() - 2) + (3, 3))
    return (x[..., 0:1] * r[..., 0, :] + x[..., 1:2] * r[..., 1, :]
            + x[..., 2:3] * r[..., 2, :])


def graphs(obj, eef, phys, d, *, n_his, n_future, max_nobj, max_nR, topk,
           augment):
    """The training graphs of B windows obj (B, T, N_raw, 3), eef (B, T,
    N_eef, 3), phys (B, P) under draws d."""
    b, _, n_raw, _ = obj.shape
    dev, n_eef = obj.device, eef.shape[2]
    valid_raw = torch.ones((b, n_raw), dtype=torch.bool, device=dev)
    idx, keep = subsample(obj[:, n_his - 1], max_nobj, d["fps_r"],
                          d["ranks"], valid_raw)
    keep_f = keep.float()
    pts = torch.gather(obj, 2, idx[:, None, :, None].expand(
        b, obj.shape[1], max_nobj, 3)) * keep_f[:, None, :, None]

    def tools(rows):
        return torch.cat([rows.new_zeros(rows.shape[:2] + (max_nobj, 3)),
                          rows], dim=2)

    action = tools((eef[:, n_his] - eef[:, n_his - 1])[:, None])[:, 0]
    state = torch.cat([pts[:, :n_his], eef[:, :n_his]], dim=2)
    future = pts[:, n_his:]
    eef_future = tools(eef[:, n_his:n_his + n_future - 1])
    action_future = tools(eef[:, n_his + 1:n_his + n_future]
                          - eef[:, n_his:n_his + n_future - 1])
    if augment:
        state = _rotate(state + d["noise"], d["theta"])
        action = _rotate(action, d["theta"])
        eef_future = _rotate(eef_future, d["theta"])
        action_future = _rotate(action_future, d["theta"])
        future = _rotate(future, d["theta"])
    ones = torch.ones((b, n_eef), dtype=torch.bool, device=dev)
    valid = torch.cat([keep, ones], 1)
    tool = torch.cat([torch.zeros_like(keep), ones], 1)
    edges = radius_edges(state[:, -1], d["adj_r"], valid, tool, topk,
                         max_edges=max_nR)
    tool_attr = torch.tensor([0.0, 1.0], device=dev).expand(b, n_eef, 2)
    attrs = torch.cat([torch.stack([keep_f, torch.zeros_like(keep_f)], -1),
                       tool_attr], 1)
    group = torch.cat([keep_f[..., None], keep_f.new_zeros((b, n_eef, 1))], 1)
    return {"state": state, "action": action, "future": future,
            "eef_future": eef_future, "action_future": action_future,
            "attrs": attrs, "group": group, "phys": phys, "edges": edges,
            "nodes": int(valid.sum()), "n_edges": int(edges[0].numel())}


def unrolled_loss(params, g, n_future, pstep, precision="f32", rows=None):
    """The sum over the n_future steps of the mean squared error over
    every object slot, each prediction fed back into the history (over
    the first `rows` graphs alone when given)."""
    state, action = g["state"], g["action"]
    n_obj = g["future"].shape[2]
    loss = 0.0
    for fi in range(n_future):
        pred = ref_model.forward(params, state, g["attrs"], g["group"],
                                 g["phys"], action, n_obj, g["edges"],
                                 pstep=pstep, precision=precision)
        loss = loss + torch.mean((pred - g["future"][:, fi])[:rows] ** 2)
        if fi < n_future - 1:
            nxt = torch.cat([pred, g["eef_future"][:, fi, n_obj:]], dim=1)
            state = torch.cat([state[:, 1:], nxt[:, None]], dim=1)
            action = g["action_future"][:, fi]
    return loss


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8), bias-corrected."""

    def __init__(self, params, lr):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params, grads):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = 0.9 * self.m[k] + 0.1 * g
            self.v[k] = 0.999 * self.v[k] + 0.001 * g * g
            out[k] = p - self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + 1e-8)
        return out
