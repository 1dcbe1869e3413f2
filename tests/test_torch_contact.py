"""Port parity: the block contact plumbing and the plain versions of the two
contact kernels (K1 block sweep, K2 block refinement) against the JAX
package, whose Pallas kernels run in interpret mode here as
tests/test_pallas_kernels.py runs them.

Tolerances: table packing, tile culling and the refined block lists are
exact (integer and copied data, and the same float32 detection math);
contact counts are exact; deltas agree within atol 2e-5, the tolerance
tests/test_pallas_kernels.py holds the Pallas sweep to (the sums run in
another order). The CUDA kernels are held to these plain versions on the
card by chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptigraph_tpu.engine import pallas_kernels as jpk
from adaptigraph_torch.engine import contact_kernels as tck


def _chain(n=512, spacing=0.05):
    """The long sparse chain of tests/test_pallas_kernels.py (a rope-like
    line with one planted overlapping pair), groups of 64."""
    rng = np.random.RandomState(2)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = np.arange(n) * spacing
    pos += rng.randn(n, 3).astype(np.float32) * 1e-3
    pos[400] = pos[10] + np.array([0.01, 0.0, 0.0], np.float32)
    return dict(pos=pos, prev=pos - rng.randn(n, 3).astype(np.float32) * 2e-3,
                group=(np.arange(n) // 64).astype(np.int32),
                inv_mass=np.ones(n, np.float32),
                sc=(np.arange(n) % 3 == 0), active=np.ones(n, bool),
                rest=rng.rand(n, 3).astype(np.float32),
                rest_dist=0.04, friction=0.25, filter_dist=0.02)


def _cloud(n=500):
    """A random cloud, spatially sorted along x so the tiles are coherent
    (as scene builders emit them), with pinned, inactive and self-colliding
    particles mixed in. 500 pads to 512."""
    rng = np.random.RandomState(5)
    pos = rng.rand(n, 3).astype(np.float32) * np.array([2.0, 0.3, 0.3],
                                                       np.float32)
    pos = pos[np.argsort(pos[:, 0])]
    active = rng.rand(n) > 0.05
    inv_mass = np.where(rng.rand(n) > 0.1, rng.rand(n) + 0.5, 0.0)
    return dict(pos=pos, prev=pos - rng.randn(n, 3).astype(np.float32) * 3e-3,
                group=rng.randint(0, 3, n).astype(np.int32),
                inv_mass=inv_mass.astype(np.float32), sc=rng.rand(n) > 0.3,
                active=active, rest=pos + rng.randn(n, 3).astype(np.float32) * 0.02,
                rest_dist=0.06, friction=0.3, filter_dist=0.05)


_SCENES = {"chain": _chain, "cloud": _cloud}


def _both(s):
    keys = ("pos", "prev", "group", "inv_mass", "sc", "active", "rest")
    return ([jnp.asarray(s[k]) for k in keys],
            [torch.as_tensor(s[k]) for k in keys])


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _pad(x, t):
    return np.concatenate([x, np.zeros(((-len(x)) % t,) + x.shape[1:], x.dtype)])


def _blocks(s, tile_j):
    """JAX and port tile_overlap_blocks on the same padded input."""
    pos, act = _pad(s["pos"], tile_j), _pad(s["active"], tile_j)
    infl = np.float32(s["rest_dist"] * 1.5)
    j = jpk.tile_overlap_blocks(jnp.asarray(pos), jnp.asarray(act),
                                jnp.float32(infl), tile_j=tile_j)
    t = tck.tile_overlap_blocks(torch.as_tensor(pos), torch.as_tensor(act),
                                _f32(infl), tile_j=tile_j)
    return j, t


@pytest.mark.parametrize("scene", sorted(_SCENES))
@pytest.mark.parametrize("tile_j", [128, 256])
def test_tables_and_tile_blocks_match_jax(scene, tile_j):
    s = _SCENES[scene]()
    ja, ta = _both(s)
    jr, jc = jpk.pack_contact_tables(*ja, tile_j=tile_j)
    tr, tc = tck.pack_contact_tables(*ta, tile_j=tile_j)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    new_pos = s["pos"] + 0.01
    jr, jc = jpk.update_contact_tables(jr, jc, jnp.asarray(new_pos),
                                       pos_prev=jnp.asarray(s["pos"]))
    tr, tc = tck.update_contact_tables(tr, tc, torch.as_tensor(new_pos),
                                       torch.as_tensor(s["pos"]))
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    (jidx, jcnt, jov), (tidx, tcnt, tov) = _blocks(s, tile_j)
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    np.testing.assert_array_equal(np.asarray(jcnt), tcnt.numpy())
    assert int(jov) == int(tov)


def test_tile_blocks_overflow_and_stable_order():
    """A capped list keeps the lowest overlapping block indices in order
    and counts what it dropped, as top_k does."""
    pos = np.zeros((1024, 3), np.float32)  # every block overlaps every block
    act = np.ones(1024, bool)
    j = jpk.tile_overlap_blocks(jnp.asarray(pos), jnp.asarray(act), 0.1,
                                max_blocks=3)
    t = tck.tile_overlap_blocks(torch.as_tensor(pos), torch.as_tensor(act),
                                _f32(0.1), max_blocks=3)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(t[2]) == 8 * 5
    np.testing.assert_array_equal(t[0].numpy(), np.tile([0, 1, 2], (8, 1)))


@pytest.mark.parametrize("scene", sorted(_SCENES))
@pytest.mark.parametrize("rest_filter", [True, False])
@pytest.mark.parametrize("tile_j", [128, 256])
def test_block_sweep_plain_matches_pallas(scene, rest_filter, tile_j):
    s = _SCENES[scene]()
    ja, ta = _both(s)
    (jidx, jcnt, _), (tidx, tcnt, _) = _blocks(s, tile_j)
    scal = (s["rest_dist"], s["friction"], s["filter_dist"])
    jd, jc = jpk.block_sparse_contact_deltas(
        *ja, *(jnp.float32(v) for v in scal), jidx, jcnt, interpret=True,
        rest_filter=rest_filter, tile_j=tile_j)
    td, tc = tck.block_sparse_contact_deltas(
        *ta, *(_f32(v) for v in scal), tidx, tcnt, rest_filter=rest_filter,
        tile_j=tile_j)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert tc.sum() > 0
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("scene", sorted(_SCENES))
@pytest.mark.parametrize("rest_filter", [True, False])
@pytest.mark.parametrize("tile_j", [128, 256])
def test_block_refine_plain_matches_pallas(scene, rest_filter, tile_j):
    s = _SCENES[scene]()
    ja, ta = _both(s)
    (jidx, jcnt, _), (tidx, tcnt, _) = _blocks(s, tile_j)
    keep = np.float32(s["rest_dist"] * 1.2)
    ji, jn = jpk.refine_overlap_blocks(
        *ja, jnp.float32(keep), jnp.float32(s["filter_dist"]), jidx, jcnt,
        interpret=True, rest_filter=rest_filter, tile_j=tile_j)
    ti, tn = tck.refine_overlap_blocks(
        *ta, _f32(keep), _f32(s["filter_dist"]), tidx, tcnt,
        rest_filter=rest_filter, tile_j=tile_j)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())


@pytest.mark.parametrize("n,spacing,tile_j", [(512, 0.05, 128),
                                               (1024, 0.07, 256)])
def test_refinement_is_lossless_on_the_port(n, spacing, tile_j):
    """The port's mirror of tests/test_pallas_kernels.py's lossless test:
    refinement drops blocks, keeps the planted contact, and the sweep over
    the refined lists equals the sweep over the unrefined ones exactly.
    (At tile_j 256 every block of the 0.05-spaced chain holds a pair within
    the keep distance, so the wide-block case spaces the chain out.)"""
    s = _chain(n, spacing)
    _, ta = _both(s)
    _, (bidx, bcnt, _) = _blocks(s, tile_j)
    ridx, rcnt = tck.refine_overlap_blocks(
        *ta, _f32(s["rest_dist"] * 1.5), _f32(s["filter_dist"]), bidx, bcnt,
        tile_j=tile_j)
    assert (rcnt <= bcnt).all()
    assert rcnt.sum() < bcnt.sum()
    assert rcnt.sum() >= 1
    scal = [_f32(v) for v in (s["rest_dist"], s["friction"], s["filter_dist"])]
    d0, c0 = tck.block_sparse_contact_deltas(*ta, *scal, bidx, bcnt,
                                             tile_j=tile_j)
    d1, c1 = tck.block_sparse_contact_deltas(*ta, *scal, ridx, rcnt,
                                             tile_j=tile_j)
    assert torch.equal(c0, c1) and c0.sum() > 0
    assert torch.equal(d0, d1)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; a device that is neither CPU nor CUDA is refused."""
    s = _chain()
    _, ta = _both(s)
    _, (bidx, bcnt, _) = _blocks(s, 128)
    k1 = tck.block_sparse_contact_deltas_packed
    k2 = tck.refine_overlap_blocks_packed
    before = (k1.launches, k2.launches)
    rows, cols = tck.pack_contact_tables(*ta)
    k1(512, rows, cols, _f32(0.04), _f32(0.25), _f32(0.0), bidx, bcnt)
    k2(512, rows, cols, _f32(0.06), _f32(0.0), bidx, bcnt)
    assert (k1.launches, k2.launches) == before
    meta = [t.to("meta") for t in (rows, cols, bidx, bcnt)]
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k1(512, meta[0], meta[1], 0.04, 0.25, 0.0, meta[2], meta[3])
    with pytest.raises(TypeError):
        k1(512, rows, cols, 0.04, 0.25, 0.0, bidx.long(), bcnt)
