"""Planning reward assembly: the port of adaptigraph_tpu/planning/costs.py.

Chamfer-to-target-pointcloud or box-distance error, material-specific
pusher-through-object collision penalties and a keep-inside-workspace bbox
penalty, combined as
reward = -w_err * error - 5 * collision - 5 * box_penalty,
with w_err = 2 / max(error) over the whole population. Every function
takes the population as a leading batch axis.
"""

from __future__ import annotations

import torch

from adaptigraph_torch.ops.losses import box_loss, chamfer, relu0
from adaptigraph_torch.utils.batch import pad_samples
from adaptigraph_torch.utils.device import resolve_device


def _xz(x):
    return x[..., [0, 2]]


def rope_penalty(state_pred, action, state_init, sim_real_ratio: float = 10.0):
    """Pusher-spawn collision penalty: exp(-d * 100) is largest when a push
    STARTS on or inside the rope (the pusher would appear inside it) and
    decays to zero a couple of pusher radii away. d is the start point's
    distance to the state before each look-ahead step."""
    bsz = action.shape[0]
    pt = action[..., :2]  # (bsz, n_look, 2) start x-z
    state_2d = torch.cat([_xz(state_init)[None, None].expand(bsz, 1, -1, -1),
                          _xz(state_pred[:, :-1])], dim=1)
    d = torch.linalg.vector_norm(pt[:, :, None] - state_2d, dim=-1).amin(-1)
    pusher_size = 0.02 * sim_real_ratio
    return torch.exp(-relu0(d - pusher_size) * 100.0)


def cloth_penalty(state_pred, action, state_init, sim_real_ratio: float = 10.0):
    """Grasp-point feasibility for cloth.

    `dmax` is normalised by its maximum over the population this call sees,
    as in the JAX package (costs.py:45). `chunked_cost` calls the penalty
    once per chunk, so a chunked population's cloth rewards depend on the
    chunk size; the port keeps that for parity."""
    pt = action[..., :2]
    state_2d = _xz(state_init)
    d = torch.linalg.vector_norm(pt[:, :, None] - state_2d[None, None], dim=-1)
    dmin = d.amin(-1)
    pusher_size = 0.005 * sim_real_ratio
    dmin = relu0(dmin - pusher_size)
    dmax = d.amax(-1)
    dmax = torch.minimum(dmax, torch.full_like(dmax, 0.4 * sim_real_ratio))
    dmax = dmax / (dmax.amax() + 1e-9)
    return 1.0 - torch.exp(-dmin * 100.0) - dmax * 0.2


def granular_penalty(state_pred, action, state_init,
                     sim_real_ratio: float = 10.0):
    """Board-pusher collision: 9 points across the board's width."""
    bsz = action.shape[0]
    x, z, theta = action[..., 0], action[..., 1], action[..., 2]
    r = 0.05 * sim_real_ratio
    dx = r * torch.sin(theta)
    dz = -r * torch.cos(theta)
    fr = torch.linspace(-1.0, 1.0, 9, dtype=action.dtype, device=action.device)
    px = x[..., None] + fr * dx[..., None]
    pz = z[..., None] + fr * dz[..., None]
    pts = torch.stack([px, pz], dim=-1)  # (bsz, n_look, 9, 2)
    state_2d = torch.cat([_xz(state_init)[None, None].expand(bsz, 1, -1, -1),
                          _xz(state_pred[:, :-1])], dim=1)
    d = torch.linalg.vector_norm(pts[:, :, :, None] - state_2d[:, :, None],
                                 dim=-1)
    d = d.amin(-1).amin(-1)
    pusher_size = 0.02 * sim_real_ratio
    return torch.exp(-relu0(d - pusher_size) * 100.0)


PENALTIES = {"rope": rope_penalty, "cloth": cloth_penalty,
             "granular": granular_penalty}


def make_error_fn(task_config, target_state=None, target_box=None,
                  device=None):
    """error_func(state (B, N, 3), mask=None) -> (B,): the distance to the
    task's box, or the chamfer distance to `target_state` (M, 3). The
    target lives on `device` (CUDA unless given)."""
    device = resolve_device(device)
    if task_config["target_type"] == "box":
        box = torch.as_tensor(target_box if target_box is not None
                              else task_config["target"], dtype=torch.float32,
                              device=device).reshape(2, 2)

        def err(state, mask=None):
            return box_loss(state, box)
    else:
        tgt = torch.as_tensor(target_state, dtype=torch.float32, device=device)

        def err(state, mask=None):
            # (1, M, 3) broadcasts against (B, N, 3): no per-sample copy
            return chamfer(state, tgt[None], x_mask=mask)
    return err


def running_cost_parts(state, action, state_cur, error_func, penalty_func,
                       bbox, obj_mask=None):
    """The per-sample cost quantities, each (bsz,): the final error, the
    error's maximum over the look-ahead steps (`error_max`, for the
    population-wide weight in `assemble_reward`), the mean collision and
    the mean bbox penalty. state (bsz, n_look, N, 3), action (bsz, n_look,
    4), state_cur (N, 3), bbox (2, 2)."""
    bsz, n_look = state.shape[0], state.shape[1]
    flat = state.reshape(bsz * n_look, state.shape[2], 3)
    mask_flat = None
    if obj_mask is not None:
        mask_flat = obj_mask[None].expand(bsz * n_look, -1)
    error = error_func(flat, mask_flat).reshape(bsz, n_look)

    collision = penalty_func(state, action, state_cur)

    big = 1e6
    if obj_mask is not None:
        m = obj_mask[None, None, :, None]
        lo_state = torch.where(m, state, torch.full_like(state, big))
        hi_state = torch.where(m, state, torch.full_like(state, -big))
    else:
        lo_state, hi_state = state, state
    lo = lo_state.amin(dim=2)
    hi = hi_state.amax(dim=2)
    box_pen = torch.stack([
        relu0(lo[..., 0] - bbox[0, 0]),
        relu0(bbox[0, 1] - hi[..., 0]),
        relu0(lo[..., 2] - bbox[1, 0]),
        relu0(bbox[1, 1] - hi[..., 2]),
    ], dim=-1)
    box_pen = torch.exp(-box_pen * 100.0).amax(dim=-1)

    return {"error": error[:, -1],
            "error_max": error.amax(dim=1),
            "collision": collision.mean(dim=1),
            "box_pen": box_pen.mean(dim=1)}


def assemble_reward(parts):
    """The population's rewards from its per-sample parts: the 2 / max(error)
    weight normalises over the WHOLE population, so it is applied after
    every chunk has landed."""
    error_weight = 2.0 / (parts["error_max"].amax() + 1e-6)
    reward = (-error_weight * parts["error"] - 5.0 * parts["collision"]
              - 5.0 * parts["box_pen"])
    return {"reward_seqs": reward, "error_seqs": parts["error"]}


def running_cost(state, action, state_cur, error_func, penalty_func, bbox,
                 obj_mask=None):
    """The reward assembly in one call: {'reward_seqs', 'error_seqs'}."""
    return assemble_reward(running_cost_parts(
        state, action, state_cur, error_func, penalty_func, bbox,
        obj_mask=obj_mask))


def chunked_cost(state, action, state_cur, error_func, penalty_func, bbox,
                 obj_mask=None, n_chunk=0):
    """`running_cost` over sub-batches of `n_chunk` samples, so that the
    chamfer's (chunk * n_look, N, M) block bounds the memory: the population
    is padded to a multiple of the chunk by repeating sample 0, each chunk's
    parts are computed in turn and the padding sliced off, then the
    population-wide weight is applied. With a penalty that reads only its
    own sample (rope, granular) the rewards equal the unchunked ones; the
    cloth penalty's normalisation is per chunk (see cloth_penalty)."""
    s = state.shape[0]
    if not n_chunk or s <= n_chunk:
        return running_cost(state, action, state_cur, error_func,
                            penalty_func, bbox, obj_mask=obj_mask)
    pad = (-s) % n_chunk
    state_p, action_p = pad_samples(state, pad), pad_samples(action, pad)
    chunks = [running_cost_parts(state_p[i:i + n_chunk],
                                 action_p[i:i + n_chunk], state_cur,
                                 error_func, penalty_func, bbox,
                                 obj_mask=obj_mask)
              for i in range(0, s + pad, n_chunk)]
    parts = {k: torch.cat([c[k] for c in chunks])[:s] for k in chunks[0]}
    return assemble_reward(parts)
