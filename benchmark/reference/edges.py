"""The plain reference of AdaptiGraph's radius graph: receiver i takes as
senders its `topk` nearest points, of those within the radius; a pair
counts only when both ends are valid points and not both are tools (the
reference's construct_edges_from_states, src/dynamics/utils.py). Ties in
distance go to the lower index. Squared distances are summed as
fma(z, z, fma(y, y, x * x)), each step exact in float64 and rounded once,
the rounding the model's training data were built with.

Returns the valid edges as (graph, receiver, sender) int64 lists, in
receiver-major order, at most `max_edges` a graph when given (the
reference pads and truncates to max_nR).
"""

from __future__ import annotations

import torch

BIG = 1e10


def sq_dist(d):
    """fma(z, z, fma(y, y, x * x)) of float32 differences (..., 3)."""
    d64 = d.double()
    acc = (d64[..., 0] * d64[..., 0]).float()
    acc = (d64[..., 1] * d64[..., 1] + acc.double()).float()
    return (d64[..., 2] * d64[..., 2] + acc.double()).float()


def radius_edges(pos, radius, valid, tool, topk: int, max_edges=None):
    """pos (B, N, 3); radius (B,) or a scalar; valid, tool (B, N) bool."""
    b, n, _ = pos.shape
    d2 = sq_dist(pos[:, :, None, :] - pos[:, None, :, :])
    ok = (valid[:, :, None] & valid[:, None, :]
          & ~(tool[:, :, None] & tool[:, None, :]))
    d2 = torch.where(ok, d2, torch.full_like(d2, BIG))
    k = min(n, topk)
    near_d2, near = torch.sort(d2, dim=-1, stable=True)
    near_d2, near = near_d2[..., :k], near[..., :k]
    r2 = torch.as_tensor(radius, dtype=torch.float32, device=pos.device)
    r2 = torch.broadcast_to(r2 * r2, (b,))
    keep = near_d2 < r2[:, None, None]
    adj = torch.zeros((b, n, n), dtype=torch.bool, device=pos.device)
    adj.scatter_(2, near, keep)
    g, r, s = adj.nonzero(as_tuple=True)  # row-major: receiver, sender
    if max_edges is not None:
        rank = torch.cumsum(torch.ones_like(g), 0) - 1
        first = torch.searchsorted(g, torch.arange(b, device=g.device))
        keep_e = (rank - first[g]) < max_edges
        g, r, s = g[keep_e], r[keep_e], s[keep_e]
    return g, r, s


def margin(pos, radius, valid, tool, topk: int):
    """(B,) the smallest relative distance of any pair's squared distance
    from the squared radius, or of the k-th nearest candidate's from the
    next one's (within the radius): how near each graph is to gaining or
    losing an edge under a rounding-sized move."""
    b, n, _ = pos.shape
    d2 = sq_dist(pos[:, :, None, :] - pos[:, None, :, :])
    ok = (valid[:, :, None] & valid[:, None, :]
          & ~(tool[:, :, None] & tool[:, None, :]))
    r2 = torch.broadcast_to(torch.as_tensor(radius, dtype=torch.float32,
                                            device=pos.device) ** 2, (b,))
    rel = torch.where(ok, (d2 - r2[:, None, None]).abs() / r2[:, None, None],
                      torch.full_like(d2, BIG))
    out = rel.flatten(1).amin(1)
    k = min(n, topk)
    if k < n:
        srt = torch.sort(torch.where(ok, d2, torch.full_like(d2, BIG)),
                         dim=-1).values
        cut = (srt[..., k] - srt[..., k - 1]) / r2[:, None]
        cut = torch.where(srt[..., k] < r2[:, None], cut,
                          torch.full_like(cut, BIG))
        out = torch.minimum(out, cut.amin(1))
    return out
