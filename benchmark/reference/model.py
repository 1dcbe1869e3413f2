"""The plain reference of AdaptiGraph's dynamics model (the GNN of
Boey-li/AdaptiGraph src/dynamics/gnn/model.py), written from its equations
in plain PyTorch: index gathers of valid edges and a sum into receivers, no
incidence matrices, no padding of edge lists.

A graph batch is described by node tensors padded to N nodes (objects
first, then the pusher or end-effector points) and by lists of its VALID
edges only: (graph, receiver, sender). Node features: attrs, the physics
parameter on object rows, the action. Edge features: both ends' attrs,
the instance-group difference, the difference of the position histories
(residuals, then the current position). Three 3-layer ReLU encoders, pstep
rounds of message passing with residual node updates, a 3-layer motion
head clamped to +-motion_clamp and added to the last position.

Products run in float32; `precision="tf32"` rounds both operands of every
product to TF32's 10-bit mantissa first, the control's precision (on the
card the harness turns the card's own TF32 on instead).
"""

from __future__ import annotations

import torch


def layer_shapes(nf: int, particle_in: int, relation_in: int) -> dict:
    """(in, out) of every dense layer, by name."""
    shapes = {}
    for enc, width in (("particle_encoder", particle_in),
                       ("relation_encoder", relation_in)):
        for i, w_in in enumerate((width, nf, nf)):
            shapes[f"{enc}.Dense_{i}"] = (w_in, nf)
    shapes["relation_propagator.Dense_0"] = (3 * nf, nf)
    shapes["particle_propagator.Dense_0"] = (2 * nf, nf)
    for i, (w_in, w_out) in enumerate(((nf, nf), (nf, nf), (nf, 3))):
        shapes[f"non_rigid_predictor.Dense_{i}"] = (w_in, w_out)
    return shapes


def widths(model_config: dict, n_his: int, phys_dim: int) -> tuple:
    """(nf, particle_in, relation_in) of the published model config."""
    mc = model_config
    nf = int(mc["nf_effect"])
    attr = int(mc["attr_dim"])
    particle_in = (attr + (n_his * 3 if int(mc["state_dim"]) > 0 else 0)
                   + phys_dim + int(mc["action_dim"])
                   + (1 if int(mc["density_dim"]) > 0 else 0))
    relation_in = ((2 * particle_in if int(mc["rel_particle_dim"]) > 0 else 0)
                   + (2 * attr if int(mc["rel_attr_dim"]) > 0 else 0)
                   + (1 if int(mc["rel_group_dim"]) > 0 else 0)
                   + (n_his * 3 if int(mc["rel_distance_dim"]) > 0 else 0))
    return nf, particle_in, relation_in


def _round_tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest; the
    gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def dense(x, params, name, precision="f32"):
    w, b = params[name + ".weight"], params[name + ".bias"]
    if precision == "tf32" and x.device.type == "cpu":
        x, w = _round_tf32(x), _round_tf32(w)
    return x @ w.t() + b


def _mlp(x, params, prefix, precision, relu_last=True):
    x = torch.relu(dense(x, params, prefix + ".Dense_0", precision))
    x = torch.relu(dense(x, params, prefix + ".Dense_1", precision))
    x = dense(x, params, prefix + ".Dense_2", precision)
    return torch.relu(x) if relu_last else x


def forward(params, state, attrs, group, phys, action, n_obj, edges,
            pstep: int = 3, motion_clamp: float = 100.0, precision="f32"):
    """One prediction step of B graphs.

    params: {layer.weight (out, in), layer.bias (out,)}; state (B, n_his,
    N, 3); attrs (B, N, 2); group (B, N, 1) the instance one-hot (zero on
    tool rows); phys (B, P); action (B, N, 3); n_obj the object rows;
    edges (g, r, s) int64 lists of the valid edges. Returns the predicted
    object positions (B, n_obj, 3)."""
    g, r, s = edges
    b, n_his, n, _ = state.shape
    hist = torch.cat([state[:, 1:] - state[:, :-1], state[:, -1:]], dim=1)
    hist = hist.permute(0, 2, 1, 3).reshape(b, n, n_his * 3)
    is_obj = (torch.arange(n, device=state.device) < n_obj)[None, :, None]
    phys_rows = torch.where(is_obj, phys[:, None, :].expand(b, n, -1),
                            torch.zeros((), device=state.device))
    node_in = torch.cat([attrs, phys_rows, action], dim=-1)

    fr, fs = g * n + r, g * n + s  # flat node indices of each edge's ends

    def at(x, idx):
        return x.reshape(b * n, -1)[idx]

    edge_in = torch.cat([
        at(attrs, fr), at(attrs, fs),
        (at(group, fr) - at(group, fs)).abs().sum(-1, keepdim=True),
        at(hist, fr) - at(hist, fs)], dim=-1)
    node_enc = _mlp(node_in, params, "particle_encoder", precision)
    edge_enc = _mlp(edge_in, params, "relation_encoder", precision)
    flat_enc = node_enc.reshape(b * n, -1)

    effect = flat_enc
    for _ in range(pstep):
        msg = torch.relu(dense(torch.cat([edge_enc, effect[fr], effect[fs]],
                                         dim=-1), params,
                               "relation_propagator.Dense_0", precision))
        agg = torch.zeros_like(effect).index_add_(0, fr, msg)
        effect = torch.relu(dense(torch.cat([flat_enc, agg], dim=-1), params,
                                  "particle_propagator.Dense_0", precision)
                            + effect)
    effect = effect.reshape(b, n, -1)[:, :n_obj]
    motion = _mlp(effect, params, "non_rigid_predictor", precision,
                  relu_last=False).clamp(-motion_clamp, motion_clamp)
    return state[:, -1, :n_obj] + motion

