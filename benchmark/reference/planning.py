"""The plain reference of AdaptiGraph's MPPI push planner (the reference's
src/planning/planner.py, forward_dynamics.py and costs.py, as the JAX
package and its port state them): action sampling and the MPPI update in
endpoint space, the push decoded into a pusher that travels `length`
repeats of push_length, the learned model rolled out one repeat at a time
with the radius graph rebuilt from each prediction and the history window
slid, then the reward: the error to the target, the pusher-spawn
collision penalty and the workspace penalty.

Sampling and the MPPI update are elementwise and follow the stated
formulas operation for operation, so that the same draws give the same
bits. The rollout and the reward are computed a block of samples at a
time, each sample run only as many repeats as its own action asks for.
"""

from __future__ import annotations

import math

import torch

from reference import model as ref_model
from reference.edges import margin as edge_margin
from reference.edges import radius_edges


def _angle(x):
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def clip(action, lower, upper):
    action = torch.cat([action[..., :2], _angle(action[..., 2:3]),
                        action[..., 3:]], dim=-1)
    return torch.minimum(torch.maximum(action, lower), upper)


def sample(act_seq, lower, upper, n_sample, draws, it, noise_level,
           push_length):
    """The population (n_sample, n_look, 4) of iteration `it`: uniform
    draws over the box at 0; after, the incumbent's endpoints perturbed by
    normal draws times noise_level times 0.1 * 10**i at look-ahead step i,
    sample 0 kept as the incumbent."""
    n_look = act_seq.shape[0]
    if it == 0:
        return draws * (upper - lower) + lower
    seqs = act_seq[None].expand(n_sample, -1, -1)
    xs, zs, th, ln = seqs[..., 0], seqs[..., 1], seqs[..., 2], seqs[..., 3]
    xe = xs - ln * push_length * torch.cos(th)
    ze = zs - ln * push_length * torch.sin(th)
    out = []
    for i in range(n_look):
        res = (0.1 * (10.0 ** i)) * (draws[i] * noise_level)
        xs_i, zs_i = xs[:, i] + res[:, 0], zs[:, i] + res[:, 1]
        xe_i, ze_i = xe[:, i] + res[:, 2], ze[:, i] + res[:, 3]
        th_i = torch.atan2(zs_i - ze_i, xs_i - xe_i)
        ln_i = (torch.sqrt((xe_i - xs_i) ** 2 + (ze_i - zs_i) ** 2)
                / push_length)
        new = clip(torch.stack([xs_i, zs_i, th_i, ln_i], -1), lower, upper)
        out.append(torch.cat([seqs[:1, i], new[1:]], dim=0))
    return torch.stack(out, dim=1)


def mppi_update(acts, rewards, reward_weight, lower, upper, push_length):
    """The softmax(reward * reward_weight) average of the population's
    endpoints, back to (x, z, theta, length): (n_look, 4)."""
    w = torch.softmax(rewards * reward_weight, dim=0)[:, None]
    xs, zs, th, ln = acts[..., 0], acts[..., 1], acts[..., 2], acts[..., 3]
    xe = xs - ln * push_length * torch.cos(th)
    ze = zs - ln * push_length * torch.sin(th)
    x, z = torch.sum(w * xs, dim=0), torch.sum(w * zs, dim=0)
    xew, zew = torch.sum(w * xe, dim=0), torch.sum(w * ze, dim=0)
    theta = torch.atan2(z - zew, x - xew)
    length = torch.sqrt((xew - x) ** 2 + (zew - z) ** 2) / push_length
    return clip(torch.stack([x, z, theta, length], -1), lower, upper)


def best_action(acts_by_iter, rewards_by_iter):
    """The highest-reward sample over the iterations, the earliest on
    ties."""
    best, best_r = None, -float("inf")
    for acts, rewards in zip(acts_by_iter, rewards_by_iter):
        bi = int(torch.argmax(rewards))
        if best is None or float(rewards[bi]) > best_r:
            best, best_r = acts[bi], float(rewards[bi])
    return best


class Task:
    """The planning task's constants, from the configuration file."""

    def __init__(self, task: dict, dyn: dict, device):
        self.push_length = float(task["push_length"])
        self.adj_thresh = float(task["adj_thresh"])
        self.topk = int(task["topk"])
        self.n_his = int(task["n_his"])
        self.ratio = float(task["sim_real_ratio"])
        self.offsets = torch.tensor(
            [float(p[1]) for p in task["pusher_points"]],
            device=device) * self.ratio
        self.n_pusher = len(task["pusher_points"])
        self.lower, self.upper = (
            torch.tensor(task[k], dtype=torch.float32, device=device)
            for k in ("action_lower_lim", "action_upper_lim"))
        self.noise_level = float(task["noise_level"])
        self.reward_weight = float(task["reward_weight"])
        self.penalty = task["penalty_type"]
        self.target_type = task["target_type"]
        b = task["bbox"]
        self.bbox = torch.tensor([[b[0] * self.ratio, b[3] * self.ratio],
                                  [b[2] * self.ratio, b[5] * self.ratio]],
                                 device=device)
        mc = dyn["model_config"]
        self.pstep = int(mc["pstep"])


def _negz(x):
    return torch.cat([x[..., :2], -x[..., 2:]], dim=-1)


def _lowest(pos, mask):
    y = pos[..., 1]
    return torch.where(mask, y, torch.full_like(y, 1e9)).amin(-1)


def rollout(params, task: Task, state, mask, acts, phys, precision="f32",
            counts=None, margins=None):
    """Predicted object states (S, n_look, nobj, 3) of the pushes acts (S,
    n_look, 4) from state (nobj, 3) under mask (nobj,). Each sample runs
    exactly its own number of repeats. `counts`, when given, is a dict
    whose 'forwards', 'nodes' and 'edges' entries are increased by the
    forwards run and the valid nodes and edges they saw. `margins`, when
    given, is a (S,) tensor lowered to each sample's smallest edge margin
    (edges.margin) over its graphs."""
    s, n_look = acts.shape[:2]
    nobj, npush, dev = state.shape[0], task.n_pusher, state.device
    n = nobj + npush
    maskb = mask[None].expand(s, -1)
    maskf = maskb.float()
    tool_attr = torch.tensor([0.0, 1.0], device=dev).expand(s, npush, 2)
    attrs = torch.cat([torch.stack([maskf, torch.zeros_like(maskf)], -1),
                       tool_attr], dim=1)
    group = torch.cat([maskf[..., None],
                       torch.zeros((s, npush, 1), device=dev)], dim=1)
    valid = torch.cat([maskb, torch.ones((s, npush), dtype=torch.bool,
                                         device=dev)], dim=1)
    tool = torch.cat([torch.zeros_like(maskb),
                      torch.ones((s, npush), dtype=torch.bool, device=dev)], 1)
    physb = phys[None].expand(s, -1)
    last = state[None].expand(s, -1, -1)
    preds = []
    for li in range(n_look):
        x, z, th, ln = acts[:, li].unbind(-1)
        xe = x - task.push_length * torch.cos(th)
        ze = z - task.push_length * torch.sin(th)
        reps = ln.to(torch.int32)
        y = _lowest(last, maskb)
        if npush == 1:
            kp = torch.stack([x, y, z], -1)[:, None]
        else:
            px = x[:, None] + task.offsets * torch.sin(th)[:, None]
            pz = z[:, None] - task.offsets * torch.cos(th)[:, None]
            kp = torch.stack([px, y[:, None].expand_as(px), pz], -1)
        step = torch.stack([xe - x, torch.zeros_like(x), ze - z], -1)
        step = step[:, None].expand(-1, npush, -1)
        action = torch.cat([torch.zeros_like(last), step], dim=1)
        cur = torch.cat([last, kp], dim=1)
        hist = cur[:, None].expand(-1, task.n_his, -1, -1)
        out = last.clone()
        rows = torch.arange(s, device=dev)
        for rep in range(1, int(reps.max()) + 1):
            live = reps[rows] >= rep  # rows still pushing
            rows, hist, cur = rows[live], hist[live], cur[live]
            if rows.numel() == 0:
                break
            m = maskb[rows]
            edges = radius_edges(cur, task.adj_thresh, valid[rows], tool[rows],
                                 task.topk)
            if margins is not None:
                margins[rows] = torch.minimum(margins[rows], edge_margin(
                    cur, task.adj_thresh, valid[rows], tool[rows], task.topk))
            if counts is not None:
                counts["forwards"] += rows.numel()
                counts["nodes"] += int(valid[rows].sum())
                counts["edges"] += int(edges[0].numel())
            pred = _negz(ref_model.forward(
                params, _negz(hist), attrs[rows], group[rows], physb[rows],
                _negz(action[rows]), nobj, edges, pstep=task.pstep,
                precision=precision))
            pred = torch.where(m[..., None], pred, torch.zeros_like(pred))
            out[rows[reps[rows] == rep]] = pred[reps[rows] == rep]
            eef = cur[:, nobj:] + step[rows]
            eef = torch.cat([eef[..., :1], _lowest(pred, m)[:, None, None]
                             .expand(-1, npush, 1), eef[..., 2:]], dim=-1)
            cur = torch.cat([pred, eef], dim=1)
            hist = torch.cat([hist[:, 1:], cur[:, None]], dim=1)
        preds.append(out)
        last = out
    return torch.stack(preds, dim=1)


def _pdist(x, y):
    d = x[..., :, None, :] - y[..., None, :, :]
    return torch.sqrt((d * d).sum(-1) + 1e-12)


def error(task: Task, states, mask, target):
    """(B,) the final error of object states (B, nobj, 3): the chamfer
    distance of the valid points to the target cloud (M, 3), or the mean
    distance of every row to the target box (2, 2) in x-z."""
    if task.target_type == "box":
        x, z = states[..., 0], states[..., 2]
        dx = torch.relu(target[0, 0] - x) + torch.relu(x - target[0, 1])
        dz = torch.relu(target[1, 0] - z) + torch.relu(z - target[1, 1])
        return torch.sqrt(dx ** 2 + dz ** 2 + 1e-12).mean(-1)
    d = _pdist(states, target[None])
    d = torch.where(mask[None, :, None], d, torch.full_like(d, 1e10))
    to_target = d.amin(-1)
    to_state = d.amin(-2)
    n_valid = mask.sum().clamp(min=1)
    return (torch.where(mask[None], to_target, torch.zeros_like(to_target))
            .sum(-1) / n_valid + to_state.mean(-1))


def collision(task: Task, state_seqs, acts, state_cur):
    """(B, n_look) the pusher-spawn penalty: exp(-100 relu(d - pusher)),
    d the start's (rope) or the board's nine points' (granular) distance to
    the points before the step, in x-z. The points before the first step
    are every row of state_cur, as the planner is given it."""
    b = acts.shape[0]
    before = torch.cat([state_cur[None, None, :, [0, 2]].expand(b, 1, -1, -1),
                        state_seqs[:, :-1][..., [0, 2]]], dim=1)
    pusher = 0.02 * task.ratio
    if task.penalty == "rope":
        d = torch.linalg.vector_norm(acts[..., None, :2] - before, dim=-1)
        d = d.amin(-1)
    else:
        x, z, th = acts[..., 0], acts[..., 1], acts[..., 2]
        r = 0.05 * task.ratio
        fr = torch.linspace(-1.0, 1.0, 9, device=acts.device)
        dx, dz = r * torch.sin(th), -r * torch.cos(th)
        pts = torch.stack([x[..., None] + fr * dx[..., None],
                           z[..., None] + fr * dz[..., None]], -1)
        d = torch.linalg.vector_norm(pts[:, :, :, None] - before[:, :, None],
                                     dim=-1).amin(-1).amin(-1)
    return torch.exp(-torch.relu(d - pusher) * 100.0)


def workspace(task: Task, state_seqs, mask):
    """(B, n_look) the workspace penalty: the largest of exp(-100 gap) over
    the valid points' x-z extent against the four sides of the bbox."""
    m = mask[None, None, :, None]
    lo = torch.where(m, state_seqs, torch.full_like(state_seqs, 1e6)).amin(2)
    hi = torch.where(m, state_seqs, torch.full_like(state_seqs, -1e6)).amax(2)
    bb = task.bbox
    gaps = torch.stack([torch.relu(lo[..., 0] - bb[0, 0]),
                        torch.relu(bb[0, 1] - hi[..., 0]),
                        torch.relu(lo[..., 2] - bb[1, 0]),
                        torch.relu(bb[1, 1] - hi[..., 2])], -1)
    return torch.exp(-gaps * 100.0).amax(-1)


def reward_parts(task: Task, state_seqs, acts, state_cur, mask, target):
    """Per-sample (error at the last step, the largest error over the
    steps, mean collision, mean workspace penalty)."""
    b, n_look = state_seqs.shape[:2]
    err = error(task, state_seqs.reshape(b * n_look, *state_seqs.shape[2:]),
                mask, target).reshape(b, n_look)
    return (err[:, -1], err.amax(1),
            collision(task, state_seqs, acts, state_cur).mean(1),
            workspace(task, state_seqs, mask).mean(1))


def largest_error(task: Task, state_seqs, mask, target, block: int = 1000):
    """The population's largest error over its steps, in blocks."""
    out = []
    for i in range(0, state_seqs.shape[0], block):
        s = state_seqs[i:i + block]
        b, n_look = s.shape[:2]
        out.append(error(task, s.reshape(b * n_look, *s.shape[2:]), mask,
                         target).amax())
    return torch.stack(out).amax()


def reward(parts, largest):
    err, _, col, box = parts
    return -(2.0 / (largest + 1e-6)) * err - 5.0 * col - 5.0 * box
