"""Point-set distances for evaluation and planning costs: the port of
adaptigraph_tpu/ops/losses.py.

Every distance matrix is one (..., N, M) reduction over the direct
differences, and the earth mover's distance is entropy-regularised
Sinkhorn run on the tensors' device, so planning rewards never leave it.
Masked entries take the value _BIG (1e10), as in the JAX package.
"""

from __future__ import annotations

import torch

_BIG = 1e10


def _pairwise_dist(x, y):
    """(..., N, M) Euclidean distances between x (..., N, D) and y (..., M,
    D), by the direct difference: sqrt(sum(diff * diff) + 1e-12). It avoids
    the cancellation of the |x|^2 + |y|^2 - 2xy form, which the
    min-reductions downstream would amplify."""
    diff = x[..., :, None, :] - y[..., None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)


def _fill(cond, x, value):
    return torch.where(cond, x, torch.full_like(x, value))


def relu0(x):
    """max(x, 0) as jnp.maximum(x, 0.0) computes it: a tie splits the
    gradient in half."""
    return torch.maximum(x, torch.zeros_like(x))


def _masked_min(x, y, x_mask, y_mask):
    d = _pairwise_dist(x, y)
    if y_mask is not None:
        d = _fill(y_mask[..., None, :], d, _BIG)
    if x_mask is not None:
        d = _fill(x_mask[..., :, None], d, _BIG)
    # amin splits a gradient evenly among ties, as jnp.min does
    return d.amin(dim=-1), d.amin(dim=-2)


def _masked_mean(v, mask):
    if mask is None:
        return v.mean(dim=-1)
    n = torch.clamp(mask.sum(dim=-1), min=1)
    return torch.sum(_fill(mask, v, 0.0), dim=-1) / n


def chamfer(x, y, x_mask=None, y_mask=None):
    """Symmetric chamfer distance, mean-aggregated per set, masked.

    x: (..., N, D), y: (..., M, D); returns (...,): the mean over x of the
    nearest y plus the mean over y of the nearest x."""
    min_xy, min_yx = _masked_min(x, y, x_mask, y_mask)
    return _masked_mean(min_xy, x_mask) + _masked_mean(min_yx, y_mask)


def masked_chamfer(state_pred, state_real, pred_mask, real_mask):
    """Batched masked chamfer (the reference's mean_chamfer)."""
    return chamfer(state_pred, state_real, pred_mask, real_mask)


def hausdorff(x, y, x_mask=None, y_mask=None):
    """Symmetric Hausdorff distance."""
    min_xy, min_yx = _masked_min(x, y, x_mask, y_mask)
    if x_mask is not None:
        min_xy = _fill(x_mask, min_xy, -_BIG)
    if y_mask is not None:
        min_yx = _fill(y_mask, min_yx, -_BIG)
    return torch.maximum(min_xy.amax(dim=-1), min_yx.amax(dim=-1))


def earth_mover_distance(x, y, x_mask=None, y_mask=None, eps: float = 0.01,
                         iters: int = 50):
    """Entropy-regularised earth mover's distance by `iters` Sinkhorn
    iterations in the log domain (uniform weights over the unmasked points;
    masked entries held at -_BIG), then the transport cost of the plan,
    its exponent clipped to +-80."""
    d = _pairwise_dist(x, y)
    m = d.shape[-1]
    if x_mask is None:
        x_mask = torch.ones(d.shape[:-1], dtype=torch.bool, device=d.device)
    if y_mask is None:
        y_mask = torch.ones(d.shape[:-2] + (m,), dtype=torch.bool,
                            device=d.device)
    a = x_mask.to(d.dtype)
    a = a / torch.clamp(a.sum(dim=-1, keepdim=True), min=1)
    b = y_mask.to(d.dtype)
    b = b / torch.clamp(b.sum(dim=-1, keepdim=True), min=1)

    log_k = -d / eps
    log_k = _fill(x_mask[..., :, None] & y_mask[..., None, :], log_k, -_BIG)
    log_a = _fill(a > 0, torch.log(torch.clamp(a, min=1e-30)), -_BIG)
    log_b = _fill(b > 0, torch.log(torch.clamp(b, min=1e-30)), -_BIG)

    f, g = torch.zeros_like(a), torch.zeros_like(b)
    for _ in range(iters):
        f = log_a - torch.logsumexp(log_k + g[..., None, :], dim=-1)
        g = log_b - torch.logsumexp(log_k + f[..., :, None], dim=-2)
        f = _fill(x_mask, f, -_BIG)
        g = _fill(y_mask, g, -_BIG)
    plan = torch.exp(torch.clamp(log_k + f[..., :, None] + g[..., None, :],
                                 -80.0, 80.0))
    return torch.sum(plan * torch.where(d >= _BIG, torch.zeros_like(d), d),
                     dim=(-2, -1))


def box_loss(state, target):
    """Mean distance of each particle to an axis-aligned x-z target box.

    state: (B, N, 3); target: (2, 2) [[xmin, xmax], [zmin, zmax]]."""
    xmin, xmax = target[0, 0], target[0, 1]
    zmin, zmax = target[1, 0], target[1, 1]
    x, z = state[..., 0], state[..., 2]
    x_diff = relu0(xmin - x) + relu0(x - xmax)
    z_diff = relu0(zmin - z) + relu0(z - zmax)
    return torch.mean(torch.sqrt(x_diff ** 2 + z_diff ** 2 + 1e-12), dim=-1)
