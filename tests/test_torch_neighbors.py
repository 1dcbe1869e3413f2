"""Port parity: the two engine helpers that no JAX module calls,
engine/neighbors.neighbor_list_tiled and engine/cells.morton_order,
against the JAX package on the CPU.

The tiled lists equal JAX's exactly (indices and valid flags), ties
included: both sides round squared distances alike (sq_dist_fma) and
break ties to the lower index (top_k_smallest). The Morton permutation
equals JAX's, index for index, on clouds with many points a cell.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.engine import cells as jcells
from adaptigraph_tpu.engine import neighbors as jnb
from adaptigraph_torch.engine import cells as tcells
from adaptigraph_torch.engine import neighbors as tnb


def _lattice(n, spacing=0.1):
    """n points of a cubic lattice (equal distances: ties everywhere)."""
    side = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    return (g.reshape(-1, 3)[:n] * spacing).astype(np.float32)


def _cloud(n, seed):
    return np.random.RandomState(seed).rand(n, 3).astype(np.float32) * 0.6


@pytest.mark.parametrize("k", [8, 300])
@pytest.mark.parametrize("kind", ["lattice", "cloud"])
def test_neighbor_list_tiled_equals_jax(kind, k):
    """N 203 (not a multiple of the tile 64), a few inactive points; k 8
    below N and k 300 above it (the neighbor axis padded)."""
    n = 203
    pos = _lattice(n) if kind == "lattice" else _cloud(n, 0)
    active = np.ones(n, bool)
    active[np.random.RandomState(1).choice(n, 9, replace=False)] = False
    radius = 0.15 if kind == "lattice" else 0.12
    ji, jv = jnb.neighbor_list_tiled(jnp.asarray(pos), radius,
                                     jnp.asarray(active), k=k, tile=64)
    ti, tv = tnb.neighbor_list_tiled(torch.from_numpy(pos), radius,
                                     torch.from_numpy(active), k=k, tile=64)
    assert ti.dtype == torch.int32 and tv.dtype == torch.bool
    assert ti.shape == (n, k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tv.any() and not tv[~torch.from_numpy(active)].any()
    di, dv = tnb.neighbor_list(torch.from_numpy(pos), radius,
                               torch.from_numpy(active), k=k)
    assert torch.equal(ti, di) and torch.equal(tv, dv)


def test_neighbor_list_tiled_one_tile_and_exact_multiple():
    """A tile wider than N, and N an exact multiple of the tile, both
    equal the dense list."""
    pos = torch.from_numpy(_cloud(128, 2))
    active = torch.ones(128, dtype=torch.bool)
    dense = tnb.neighbor_list(pos, 0.15, active, k=16)
    for tile in (32, 1024):
        tiled = tnb.neighbor_list_tiled(pos, 0.15, active, k=16, tile=tile)
        assert torch.equal(tiled[0], dense[0])
        assert torch.equal(tiled[1], dense[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_morton_order_equals_jax(seed):
    """500 points in a box 0.3 wide at cell 0.05 (about 2 points a cell:
    tied codes, kept in index order by the stable sort), and the same
    cloud offset far from the origin."""
    pos = _cloud(500, seed) * 0.5
    for p in (pos, pos + np.float32(7.3)):
        expect = jcells.morton_order(p.copy(), cell=0.05)
        got = tcells.morton_order(p.copy(), cell=0.05)
        assert got.dtype == expect.dtype
        np.testing.assert_array_equal(got, expect)
        codes = np.floor((p - p.min(0)) / 0.05).astype(np.int64)
        assert len({tuple(c) for c in codes}) < len(p)  # ties are present
    assert sorted(tcells.morton_order(pos)) == list(range(len(pos)))
