"""Particle neighbor search: a fixed-K neighbor list by a dense masked
top-k, the port of adaptigraph_tpu/engine/neighbors.py's `neighbor_list`,
the sparse contact mode's neighbor find up to 1,024 particles.

It returns (idx (N, K) int32, valid (N, K) bool), self and inactive
particles excluded, pairs at or beyond `radius` invalid, invalid slots
index 0. The top-k keeps the JAX package's tie order (`lax.top_k`: the
lower index first) by a stable sort.

Squared distances are rounded as the JAX package's are on the CPU
(sq_dist_fma, worked in float64), a choice made for parity: it lets the
CPU tests hold this find, the cell list's and the sparse mode's rest
filter to JAX's exactly, ties included. The JAX package on a TPU rounds
otherwise, so the port agrees exactly with JAX on the CPU only. On the
card it costs a float64 pass over the candidate differences; PERF.md
gives its time at the sparse path's size (chip_smoke.py's
`sparse_sq_dist_cost` phase).
"""

from __future__ import annotations

import torch

_BIG = 1e10


def sq_dist(d):
    """Squared length of (..., 3) differences, summed x, y, z in order."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def sq_dist_fma(d):
    """Squared length of float32 (..., 3) differences as XLA computes
    `sum(d * d, -1)` on the CPU: the reduction contracted into fused
    multiply-adds, fma(z, z, fma(y, y, x * x)). Each step here is exact in
    float64 and rounded once to float32, as a fused multiply-add is. The
    plain sum differs from it by an ulp on about half of all pairs, which
    reorders neighbors at equal distance, and moves a pair across the
    cutoff."""
    d64 = d.to(torch.float64)
    acc = (d64[..., 0] * d64[..., 0]).to(d.dtype)
    acc = (d64[..., 1] * d64[..., 1] + acc.to(torch.float64)).to(d.dtype)
    return (d64[..., 2] * d64[..., 2] + acc.to(torch.float64)).to(d.dtype)


def top_k_smallest(d2, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, the lower index first on ties (lax.top_k's order on -d2)."""
    order = torch.argsort(d2, dim=-1, stable=True)[..., :k]
    return torch.gather(d2, -1, order), order


def neighbor_list(pos, radius, active, k: int = 32):
    """Dense fixed-K neighbor list: one (N, N) distance table and a top-k.

    pos (N, 3), radius a scalar cutoff, active (N,) mask, k the neighbor
    cap. Returns (idx, valid), each (N, K)."""
    n = pos.shape[0]
    d2 = sq_dist_fma(pos[:, None, :] - pos[None, :, :])  # (N, N)
    ids = torch.arange(n, device=pos.device)
    invalid = (~active)[None, :] | (ids[None, :] == ids[:, None])
    d2 = torch.where(invalid, torch.full_like(d2, _BIG), d2)
    keff = min(k, n)
    vals, idx = top_k_smallest(d2, keff)
    valid = vals < radius * radius
    if keff < k:  # tiny scenes: pad the neighbor axis to the requested K
        idx = torch.cat([idx, idx.new_zeros((n, k - keff))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((n, k - keff))], dim=1)
    valid = valid & active[:, None]
    idx = idx.to(torch.int32)
    return torch.where(valid, idx, torch.zeros_like(idx)), valid
