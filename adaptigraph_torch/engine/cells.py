"""Spatial-hash cell-list neighbor search, the port of
adaptigraph_tpu/engine/cells.py: the sparse contact mode's neighbor find
above 1,024 particles.

  1. bin: cell = floor(pos / radius), hashed into a power-of-two table (no
     scene bounds needed: aliased cells only add candidates the distance
     filter drops);
  2. bucket: one stable argsort over the hashes groups co-cell particles;
     each particle's rank in its cell comes from a searchsorted, and one
     indexed write builds the (table + 1, bucket) -> particle map (row
     `table` is the trash row, written many times, always with n);
  3. query: the 27-cell stencil's buckets (27 * bucket candidates a row),
     stencil cells aliasing to one hash row visited once, a distance
     filter, and a top-k down to K.

`morton_order` is the JAX module's host helper: a Z-order permutation of
a point cloud, in numpy.

Output as neighbors.neighbor_list: (idx (N, K) int32, valid (N, K) bool).
The hash is computed in int64 and masked with table - 1: its low bits are
those of the JAX version's wrapped int32 products, so both sides bin
alike. Ties in the top-k go to the lower candidate slot, as lax.top_k's
do, over squared distances rounded as the JAX package's are on the CPU
(neighbors.sq_dist_fma).
"""

from __future__ import annotations

import numpy as np
import torch

from adaptigraph_torch.engine.neighbors import (
    _BIG, sq_dist_fma, top_k_smallest)

# 3x3x3 stencil offsets
_STENCIL = np.array([(dx, dy, dz)
                     for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], dtype=np.int64)  # (27, 3)
_P1, _P2, _P3 = 73856093, 19349663, 83492791  # classic spatial-hash primes


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def _hash_cells(cell, table_size: int):
    """cell (..., 3) int64 -> hash in [0, table_size), table_size a power
    of two."""
    h = (cell[..., 0] * _P1) ^ (cell[..., 1] * _P2) ^ (cell[..., 2] * _P3)
    return h & (table_size - 1)


def _cells(scaled):
    """int64 cell coordinates of float32 scaled positions: floor, then the
    int32 conversion the JAX version makes."""
    return torch.floor(scaled).to(torch.int32).to(torch.int64)


def cell_list_neighbors(pos, radius, active, k: int = 24,
                        bucket_size: int = 8, table_size: int | None = None):
    """Fixed-K neighbor list through a hashed cell grid.

    pos (N, 3), radius the search cutoff (and cell edge), active (N,) mask,
    k the neighbor cap, bucket_size the particles kept a cell (the rest
    are not found by others; cell_bucket_overflow counts them), table_size
    the hash rows (a power of two; default the next one above 4N).
    Returns (idx (N, K) int32, valid (N, K) bool)."""
    n = pos.shape[0]
    dev = pos.device
    table = table_size or _next_pow2(4 * n)
    inv_cell = 1.0 / radius
    cell = _cells(pos * inv_cell)  # (N, 3)
    trash = torch.full((n,), table, dtype=torch.int64, device=dev)
    h = torch.where(active, _hash_cells(cell, table), trash)

    # the (table + 1, B) bucket map from one stable sort
    order = torch.argsort(h, stable=True)
    h_sorted = h[order]
    first = torch.searchsorted(h_sorted, h_sorted, side="left")
    rank = torch.arange(n, device=dev) - first  # rank within the cell
    in_bucket = (rank < bucket_size) & (h_sorted < table)
    row = torch.where(in_bucket, h_sorted, trash)
    slot = torch.clamp(rank, 0, bucket_size - 1)
    buckets = torch.full((table + 1, bucket_size), n, dtype=torch.int64,
                         device=dev)
    buckets[row, slot] = torch.where(in_bucket, order,
                                     torch.full_like(order, n))

    # the 27-cell stencil
    stencil = torch.as_tensor(_STENCIL, device=dev)
    h27 = _hash_cells(cell[:, None, :] + stencil[None], table)  # (N, 27)
    # two stencil cells may alias to one hash row: visit each row once
    h27s = torch.sort(h27, dim=1).values
    dup = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                     h27s[:, 1:] == h27s[:, :-1]], dim=1)
    cand = buckets[h27s]  # (N, 27, B)
    cand = torch.where(dup[..., None], torch.full_like(cand, n), cand)
    cand = cand.reshape(n, 27 * bucket_size)

    # distance filter and top-k
    cand_ok = cand < n
    cand_safe = torch.where(cand_ok, cand, torch.zeros_like(cand))
    d2 = sq_dist_fma(pos[:, None, :] - pos[cand_safe])  # (N, 27B)
    me = torch.arange(n, device=dev)[:, None]
    eligible = cand_ok & (cand_safe != me) & (d2 < radius * radius)
    d2 = torch.where(eligible, d2, torch.full_like(d2, _BIG))
    keff = min(k, cand.shape[1])
    vals, col = top_k_smallest(d2, keff)
    idx = torch.gather(cand_safe, 1, col)
    valid = vals < _BIG * 0.5
    if keff < k:
        idx = torch.cat([idx, idx.new_zeros((n, k - keff))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((n, k - keff))], dim=1)
    valid = valid & active[:, None]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), valid


def cell_bucket_overflow(pos, radius, active, bucket_size: int = 8,
                         table_size: int | None = None):
    """How many active particles do not fit their cell's bucket (others'
    stencils do not find them; they still find their own neighbors). Bins
    with pos / radius, as the JAX diagnostic does (cell_list_neighbors
    multiplies by 1 / radius). Returns a 0-d int64 tensor."""
    n = pos.shape[0]
    table = table_size or _next_pow2(4 * n)
    cell = _cells(pos / radius)
    h = torch.where(active, _hash_cells(cell, table),
                    torch.full((n,), table, dtype=torch.int64,
                               device=pos.device))
    h_sorted = torch.sort(h).values
    first = torch.searchsorted(h_sorted, h_sorted, side="left")
    rank = torch.arange(n, device=pos.device) - first
    return torch.sum((rank >= bucket_size) & (h_sorted < table))


def morton_order(pos, cell: float = 0.05):
    """The Morton (Z-order) permutation of a point cloud (N, 3), in numpy
    on the host: each point's cell floor((p - min) / cell), 21 bits an
    axis, interleaved x, y, z from the lowest bit, stably sorted. Scene
    builders emit spatially coherent orders (chains, grids), which the
    block-sparse sweep's tile culling relies on; this sorts an arbitrary
    cloud so at build time. Returns the permutation's indices: remap
    spring and cluster indices through it."""
    p = np.asarray(pos)
    q = np.floor((p - p.min(axis=0)) / cell).astype(np.uint64)
    q = np.minimum(q, (1 << 21) - 1)

    def spread(x):
        x &= 0x1FFFFF
        x = (x | (x << 32)) & 0x1F00000000FFFF
        x = (x | (x << 16)) & 0x1F0000FF0000FF
        x = (x | (x << 8)) & 0x100F00F00F00F00F
        x = (x | (x << 4)) & 0x10C30C30C30C30C3
        x = (x | (x << 2)) & 0x1249249249249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")
