"""Particle neighbor search: a fixed-K neighbor list by a dense masked
top-k, the port of adaptigraph_tpu/engine/neighbors.py's `neighbor_list`,
the sparse contact mode's neighbor find up to 1,024 particles, and of its
`neighbor_list_tiled`, the same lists computed in row tiles so that the
distance table never exceeds (tile, N).

Both return (idx (N, K) int32, valid (N, K) bool), self and inactive
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


def _row_block_neighbors(pos_block, pos, row_ids, active, radius, k: int):
    """(idx, valid) of the k nearest of `pos` (N, 3) to each of the rows
    pos_block (T, 3) whose indices are row_ids (T,): self and inactive
    columns excluded, pairs at or beyond `radius` invalid, the neighbor
    axis padded to k beyond N."""
    t, n = pos_block.shape[0], pos.shape[0]
    d2 = sq_dist_fma(pos_block[:, None, :] - pos[None, :, :])  # (T, N)
    ids = torch.arange(n, device=pos.device)
    invalid = (~active)[None, :] | (ids[None, :] == row_ids[:, None])
    d2 = torch.where(invalid, torch.full_like(d2, _BIG), d2)
    keff = min(k, n)
    vals, idx = top_k_smallest(d2, keff)
    valid = vals < radius * radius
    if keff < k:  # tiny scenes: pad the neighbor axis to the requested K
        idx = torch.cat([idx, idx.new_zeros((t, k - keff))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((t, k - keff))], dim=1)
    return idx, valid


def neighbor_list(pos, radius, active, k: int = 32):
    """Dense fixed-K neighbor list: one (N, N) distance table and a top-k.

    pos (N, 3), radius a scalar cutoff, active (N,) mask, k the neighbor
    cap. Returns (idx, valid), each (N, K)."""
    n = pos.shape[0]
    idx, valid = _row_block_neighbors(
        pos, pos, torch.arange(n, device=pos.device), active, radius, k)
    valid = valid & active[:, None]
    idx = idx.to(torch.int32)
    return torch.where(valid, idx, torch.zeros_like(idx)), valid


def neighbor_list_tiled(pos, radius, active, k: int = 32, tile: int = 1024):
    """neighbor_list in row tiles of `tile`: the rows padded with zeros to
    a multiple of the tile, as JAX pads them, each tile's (tile, N)
    distance table and top-k in turn, the padding sliced off. Each row's
    list is computed as neighbor_list computes it, so the two are equal.
    Returns (idx, valid), each (N, K)."""
    n = pos.shape[0]
    pad = (-n) % tile
    pos_p = torch.cat([pos, pos.new_zeros((pad, 3))])
    rows = torch.arange(n + pad, device=pos.device)
    parts = [_row_block_neighbors(pos_p[r0:r0 + tile], pos,
                                  rows[r0:r0 + tile], active, radius, k)
             for r0 in range(0, n + pad, tile)]
    idx = torch.cat([p[0] for p in parts])[:n]
    valid = torch.cat([p[1] for p in parts])[:n] & active[:, None]
    idx = idx.to(torch.int32)
    return torch.where(valid, idx, torch.zeros_like(idx)), valid
