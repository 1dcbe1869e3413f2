"""Batched GNN rollouts for planning: the port of
adaptigraph_tpu/planning/forward_dynamics.py.

Decode (x, z, theta, length) actions into pusher segments, build the
planning graph with a 1-point (rope, cloth) or 5-point (granular board)
pusher, then roll the model `length` repeats of push_length, rebuilding
the radius edges from the predicted state after every repeat and sliding
the history window.

The population is one batch: the model and the edge builder take the
sample axis natively, so a repeat is one forward and one edge rebuild for
a whole chunk. The repeat loop always runs to the static maximum
(action_upper_lim[3]) and records each sample's prediction at its own
repeat count, so no step waits on the host. `n_sample_chunk` bounds the
live memory: a larger population runs chunk after chunk, padded to a
multiple of the chunk by repeating sample 0 and sliced back.

The rollout runs on the object rows some sample holds only: once a call,
before chunking, it reads which rows of the mask any sample holds (one
host read), runs every chunk on those rows (ascending, so the edge
builder's stable sorts and ties pick the same neighbours, renumbered) and
scatters the result back into the padded layout. A row no sample holds is
read by nothing valid (an edge needs both ends valid, the model reduces
over edges alone), and the full-width loop leaves it at the input state
until a look-ahead step with 1 to max repeats, and at zero from then on:
the scatter writes that. A mask that holds every row runs at full width.

Spans (utils/profiling): `rollout.chunk` around a chunk, `rollout.forward`
around each model forward and `rollout.edges` around each edge rebuild,
each tagged with the chunk's batch. Counters: `rollout.sample_forwards_run`
(batch x repeats run, a chunk and look-ahead step),
`rollout.sample_forwards_needed` (each real sample's own repeats; chunk
padding rows are run, not needed), and for each forward
`rollout.edge_slots`, `rollout.valid_edges` and `rollout.valid_nodes`
(what the edge builder is given); `rollout.node_slots_run` and
`rollout.node_slots_full` (batch x node rows run, and batch x node rows of
the padded layout, a chunk and look-ahead step).
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from adaptigraph_torch.ops.edges import build_edges_slotted_batch
from adaptigraph_torch.planning.actions import decode_action
from adaptigraph_torch.utils import profiling
from adaptigraph_torch.utils.batch import pad_samples


def _negz(x):
    """Mirror plan frame <-> flex frame (z negated; see make_batched_dynamics)."""
    return torch.cat([x[..., :2], -x[..., 2:]], dim=-1)


def _batch(x, s, ndim):
    """x with a leading sample axis of s: broadcast when x lacks it."""
    return x[None].expand((s,) + tuple(x.shape)) if x.dim() == ndim else x


def _kept_rows(mask):
    """The object rows (ascending, on the mask's device) that some sample
    of mask (nobj,) or (S, nobj) holds; None where that is every row or
    none. One read of the mask by the host."""
    m = mask if mask.dim() == 1 else mask.bool().any(0)
    kept = torch.nonzero(m.cpu().bool()).squeeze(1)
    if kept.numel() in (0, m.numel()):
        return None
    return kept.to(mask.device)


def make_batched_dynamics(model, task_config, eef_y_mode: str = "min"):
    """The population rollout of `model` (a DynamicsPredictor) under a
    planning task config (configs/planning/*.yaml's task_config).

    eef_y_mode: the pusher's height, 'min' over the object (planning) or
    'mean' (the masked replay).

    Returns rollout(params, state (nobj, 3) or (S, nobj, 3), obj_mask,
    actions (S, n_look, 4), physics_param (phys,) or (S, phys)) -> dict with
    state_seqs (S, n_look, nobj, 3) and action_seqs (S, n_look, 4), the
    decoded segments. `params` is a state_dict of `model`; every tensor is
    on the actions' device. The rollout is differentiable in the actions
    (the planner's GD path); the MPPI path runs it under no_grad."""
    chunk_size = int(task_config.get("n_sample_chunk", 0) or 0)
    pusher_points = task_config["pusher_points"]
    n_pusher = len(pusher_points)
    sim_real_ratio = float(task_config["sim_real_ratio"])
    push_length = float(task_config["push_length"])
    adj_thresh = float(task_config["adj_thresh"])
    topk = int(task_config["topk"])
    cta = bool(task_config["connect_tools_all"])
    n_his = int(task_config["n_his"])
    gripper = bool(task_config.get("gripper_enable", False))
    max_repeat = int(task_config["action_upper_lim"][3])
    # board sample offsets along the pusher's width
    offs = torch.tensor([float(p[1]) for p in pusher_points]) * sim_real_ratio
    lift = 0.01 * sim_real_ratio if gripper else 0.0

    def eef_geometry(decoded, theta, y):
        """(B, P, 3) pusher keypoints and (B, P, 3) per-repeat deltas."""
        xs, zs, xe, ze = decoded.unbind(-1)
        delta = torch.stack([xe - xs, torch.zeros_like(xs), ze - zs], -1)
        if n_pusher == 1:
            kp = torch.stack([xs, y, zs], -1)[:, None]
        else:
            o = offs.to(decoded.device)
            px = xs[:, None] + o * torch.sin(theta)[:, None]
            pz = zs[:, None] - o * torch.cos(theta)[:, None]
            kp = torch.stack([px, y[:, None].expand_as(px), pz], -1)
        if gripper:
            kp = torch.cat([kp[..., :1], kp[..., 1:2] + lift, kp[..., 2:]],
                           dim=-1)
        return kp, delta[:, None].expand(-1, n_pusher, -1)

    def obj_y(pred, mask):
        """(B,) the pusher's height from the object's predicted state."""
        if eef_y_mode == "min":
            return torch.where(mask, pred[..., 1],
                               torch.full_like(pred[..., 1], 1e9)).amin(-1)
        return (torch.sum(pred[..., 1] * mask, -1)
                / torch.clamp(mask.sum(-1), min=1))

    def edges(states, state_mask, eef_mask):
        with profiling.span("rollout.edges", states.shape[0]):
            e = build_edges_slotted_batch(states, adj_thresh, state_mask,
                                          eef_mask, topk=topk,
                                          connect_tools_all=cta,
                                          tools_only_when_near=True)
        profiling.count("rollout.edge_slots", e.valid.numel())
        profiling.count("rollout.valid_edges", e.valid)
        profiling.count("rollout.valid_nodes", state_mask)
        return e.receivers, e.senders, e.valid

    def run(params, state, mask, acts, physics, full, real=None):
        """One chunk: state (B, nobj, 3), mask (B, nobj), acts (B, n_look,
        4), physics (B, phys) -> (B, n_look, nobj, 3). `full` is the
        padded layout's object rows. The first `real` rows (all when None)
        are the population's; the rest pad the chunk."""
        with profiling.span("rollout.chunk", state.shape[0]):
            return _run(params, state, mask, acts, physics, full, real)

    def _run(params, state, mask, acts, physics, full, real):
        b, nobj = state.shape[:2]
        n_look = acts.shape[1]
        dev = state.device
        maskf = mask.to(torch.float32)
        tool_attr = torch.zeros((b, n_pusher, 2), device=dev)
        tool_attr[..., 1] = 1.0
        attrs = torch.cat([torch.stack([maskf, torch.zeros_like(maskf)], -1),
                           tool_attr], dim=1)
        p_instance = maskf[..., None]
        tools = torch.ones((b, n_pusher), dtype=torch.bool, device=dev)
        state_mask = torch.cat([mask, tools], dim=1)
        eef_mask = torch.cat([torch.zeros_like(mask), tools], dim=1)
        decoded_all, repeats_all = decode_action(acts, push_length)

        last = state
        preds = []
        for li in range(n_look):
            decoded, repeats = decoded_all[:, li], repeats_all[:, li]
            profiling.count("rollout.sample_forwards_run", b * max_repeat)
            profiling.count("rollout.sample_forwards_needed",
                            repeats[:real])
            profiling.count("rollout.node_slots_run", b * (nobj + n_pusher))
            profiling.count("rollout.node_slots_full", b * (full + n_pusher))
            y = obj_y(last, mask)
            eef_kp, eef_delta = eef_geometry(decoded, acts[:, li, 2], y)
            hist = torch.cat([last, eef_kp], dim=1)[:, None].expand(
                -1, n_his, -1, -1)
            delta = torch.cat([torch.zeros_like(last), eef_delta], dim=1)
            recv, send, valid = edges(hist[:, -1], state_mask, eef_mask)
            pred_rec = last
            for ai in range(1, max_repeat + 1):
                # The planner works in the PLAN frame (flex z negated) but
                # the model was trained on FLEX-frame episodes, and an MLP
                # message net is not parity-equivariant: mirror in and out
                # at the model boundary. Edges come from plan-frame states;
                # distances are mirror-invariant, so the same lists apply.
                with profiling.span("rollout.forward", b):
                    pred, _ = functional_call(
                        model, params, (_negz(hist), attrs, recv, send,
                                        valid, p_instance, physics),
                        {"action": _negz(delta)})
                pred = _negz(pred)
                pred = torch.where(mask[..., None], pred,
                                   torch.zeros_like(pred))
                pred_rec = torch.where((repeats == ai)[:, None, None], pred,
                                       pred_rec)
                if ai == max_repeat:
                    break  # the last repeat's graph would be used by none
                eef_cur = hist[:, -1, nobj:] + delta[:, nobj:]
                y_cur = (obj_y(pred, mask) + lift)[:, None]
                eef_cur = torch.cat([eef_cur[..., :1], y_cur[..., None]
                                     .expand(-1, n_pusher, 1),
                                     eef_cur[..., 2:]], dim=-1)
                states_cur = torch.cat([pred, eef_cur], dim=1)
                recv, send, valid = edges(states_cur, state_mask, eef_mask)
                hist = torch.cat([hist[:, 1:], states_cur[:, None]], dim=1)
            preds.append(pred_rec)
            last = pred_rec
        return torch.stack(preds, dim=1)

    def widen(seqs, state, kept, repeats):
        """(S, n_look, k, 3) rows at `kept` -> (S, n_look, nobj, 3) in the
        padded layout of state (S, nobj, 3): every other row is the input
        state's until a look-ahead step with 1 to max repeats, zero from
        then on, as the full-width loop leaves a row no sample holds."""
        moved = torch.cumsum(((repeats >= 1) & (repeats <= max_repeat))
                             .to(torch.int32), dim=1) > 0
        out = torch.where(moved[..., None, None], 0.0, state[:, None])
        return out.index_copy(2, kept, seqs)

    def rollout(params, state, obj_mask, actions, physics_param):
        s = actions.shape[0]
        full = state.shape[-2]
        kept = _kept_rows(obj_mask)
        if kept is not None:
            state_k = state.index_select(-2, kept)
            mask_k = obj_mask.index_select(-1, kept)
        else:
            state_k, mask_k = state, obj_mask
        state_b = _batch(state_k, s, 2)
        mask_b = _batch(mask_k, s, 1).bool()
        phys_b = _batch(physics_param, s, 1)
        if chunk_size and s > chunk_size:
            # pad to the next chunk multiple (sample 0 repeated, sliced
            # off below): a population the chunk does not divide must not
            # fall back to one full batch
            pad = (-s) % chunk_size
            args = [pad_samples(x, pad) for x in (state_b, mask_b, actions,
                                                  phys_b)]
            seqs = torch.cat([
                run(params, *(x[i:i + chunk_size] for x in args), full,
                    real=min(chunk_size, s - i))
                for i in range(0, s + pad, chunk_size)])[:s]
        else:
            seqs = run(params, state_b, mask_b, actions, phys_b, full)
        decoded, repeats = decode_action(actions, push_length)
        if kept is not None:
            seqs = widen(seqs, _batch(state, s, 2), kept, repeats)
        return {"state_seqs": seqs, "action_seqs": decoded}

    return rollout


def make_masked_replay(model, task_config):
    """Replay logged interactions (per-sample initial states, masks and
    single actions) under a candidate physics parameter, for the online
    physics-parameter optimiser: replay(params, state_init (B, nobj, 3),
    state_mask (B, nobj), actions (B, 4), physics_param (B, phys)) ->
    {'state_seqs' (B, nobj, 3), 'action_seqs' (B, 4)}."""
    base = make_batched_dynamics(model, task_config, eef_y_mode="mean")

    def replay(params, state_init, state_mask, actions, physics_param):
        out = base(params, state_init, state_mask, actions[:, None, :],
                   physics_param)
        return {"state_seqs": out["state_seqs"][:, 0],
                "action_seqs": out["action_seqs"][:, 0]}

    return replay
