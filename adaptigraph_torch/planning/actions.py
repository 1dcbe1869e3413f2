"""Push-action encoding and the MPPI action-space operators: the port of
adaptigraph_tpu/planning/actions.py.

A push action is (x_start, z_start, theta, length): the pusher travels
`length` repeats of `push_length` in direction theta from the start point;
`length`, truncated to an integer, is the number of model steps. The MPPI
proposal and update work in ENDPOINT space: actions become (start, end)
points, are perturbed or softmax-averaged there, and go back to (theta,
length).

Randomness is passed in: `sample_action_seq` takes its draws as tensors
(the uniform block at iteration 0, one standard-normal block a look-ahead
step after that), so that the JAX package's own draws can be replayed;
`draw_action_noise` draws those blocks from a torch.Generator.
"""

from __future__ import annotations

import math

import torch


def decode_action(action, push_length: float = 0.10):
    """(..., 4) [x, z, theta, length] -> ((..., 4) [xs, zs, xe, ze],
    repeats): one decoded segment covers a single `push_length` step;
    `repeats` is `length` truncated to int32."""
    x, z, theta, length = action.unbind(-1)
    repeats = length.to(torch.int32)
    xe = x - push_length * torch.cos(theta)
    ze = z - push_length * torch.sin(theta)
    return torch.stack([x, z, xe, ze], dim=-1), repeats


def decode_action_single(action, push_length: float = 0.10):
    """The full extent of one action, for execution: (xs, zs, xe, ze) as
    Python floats."""
    x, z, theta = float(action[0]), float(action[1]), float(action[2])
    rep = int(action[3])
    return (x, z, x - push_length * rep * math.cos(theta),
            z - push_length * rep * math.sin(theta))


def angle_normalize(x):
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def clip_actions(action, lower, upper):
    """The angle wrapped to [-pi, pi), then every component clipped to
    [lower, upper] (as jnp.clip: max then min, ties splitting a gradient)."""
    action = torch.cat([action[..., :2], angle_normalize(action[..., 2:3]),
                        action[..., 3:]], dim=-1)
    return torch.minimum(torch.maximum(action, lower), upper)


def draw_action_noise(n_sample: int, n_look: int, adim: int, iter_index: int,
                      generator: torch.Generator, device=None):
    """The draws `sample_action_seq` takes, from `generator` on its device:
    at iteration 0 a uniform [0, 1) block (n_sample, n_look, adim), after
    that a standard-normal block (n_look, n_sample, 4)."""
    device = generator.device if device is None else device
    if iter_index == 0:
        return torch.rand((n_sample, n_look, adim), generator=generator,
                          device=device)
    return torch.randn((n_look, n_sample, 4), generator=generator,
                       device=device)


def sample_action_seq(act_seq, lower, upper, n_sample: int, draws,
                      iter_index: int = 0, noise_level: float = 0.3,
                      push_length: float = 0.10):
    """MPPI proposals (n_sample, n_look, 4). Iteration 0 spreads the uniform
    `draws` (n_sample, n_look, adim) over the action box; later iterations
    perturb the incumbent act_seq (n_look, 4) in endpoint space with the
    normal `draws` (n_look, n_sample, 4) times noise_level times beta = 0.1
    * 10**i at look-ahead step i, and keep sample 0 as the unperturbed
    incumbent."""
    n_look, _ = act_seq.shape
    if iter_index == 0:
        return draws * (upper - lower) + lower

    seqs = act_seq[None].expand(n_sample, -1, -1)
    xs, zs = seqs[..., 0], seqs[..., 1]
    thetas, lengths = seqs[..., 2], seqs[..., 3]
    xe = xs - lengths * push_length * torch.cos(thetas)
    ze = zs - lengths * push_length * torch.sin(thetas)

    steps = []
    for i in range(n_look):
        noise = draws[i] * noise_level
        res = (0.1 * (10.0 ** i)) * noise
        xs_i = xs[:, i] + res[:, 0]
        zs_i = zs[:, i] + res[:, 1]
        xe_i = xe[:, i] + res[:, 2]
        ze_i = ze[:, i] + res[:, 3]
        th_i = torch.atan2(zs_i - ze_i, xs_i - xe_i)
        ln_i = torch.sqrt((xe_i - xs_i) ** 2 + (ze_i - zs_i) ** 2) / push_length
        new_i = clip_actions(torch.stack([xs_i, zs_i, th_i, ln_i], -1), lower,
                             upper)
        # sample 0 stays the incumbent
        steps.append(torch.cat([seqs[:1, i], new_i[1:]], dim=0))
    return torch.stack(steps, dim=1)


def optimize_action_mppi(act_seqs, reward_seqs, reward_weight: float = 100.0,
                         lower=None, upper=None, push_length: float = 0.10):
    """The softmax-weighted MPPI update in endpoint space: (n_look, 4)."""
    w = torch.softmax(reward_seqs * reward_weight, dim=0)[:, None]
    xs, zs = act_seqs[..., 0], act_seqs[..., 1]
    thetas, lengths = act_seqs[..., 2], act_seqs[..., 3]
    xe = xs - lengths * push_length * torch.cos(thetas)
    ze = zs - lengths * push_length * torch.sin(thetas)
    x = torch.sum(w * xs, dim=0)
    z = torch.sum(w * zs, dim=0)
    xew = torch.sum(w * xe, dim=0)
    zew = torch.sum(w * ze, dim=0)
    theta = torch.atan2(z - zew, x - xew)
    length = torch.sqrt((xew - x) ** 2 + (zew - z) ** 2) / push_length
    out = torch.stack([x, z, theta, length], dim=-1)
    return clip_actions(out, lower, upper)
