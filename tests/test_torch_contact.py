"""Port parity: the contact plumbing and the plain versions of the four
contact kernels (K1 block sweep, K2 block refinement, K3 dense sweep, K4
the shape stage fused into K1) against the JAX package, whose Pallas
kernels run in interpret mode here as tests/test_pallas_kernels.py runs
them.

Tolerances: table packing, tile culling and the refined block lists are
exact (integer and copied data, and the same float32 detection math);
contact counts are exact; deltas agree within atol 2e-5, the tolerance
tests/test_pallas_kernels.py holds the Pallas sweeps to (the sums run in
another order). The CUDA kernels are held to these plain versions on the
card by chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptigraph_tpu.engine import pallas_kernels as jpk
from adaptigraph_torch.engine import contact_kernels as tck
from chip_smoke import FOUR_KINDS, SEVEN_SLOTS, edge_block_lists


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


@pytest.mark.parametrize("rest_filter", [True, False])
@pytest.mark.parametrize("tile_j", [128, 256])
def test_block_refine_plain_matches_pallas_on_edge_lists(rest_filter, tile_j):
    """K2's edge cases, on the synthetic lists chip_smoke.py holds the
    kernel to (edge_block_lists): tiles listing no block, tiles listing
    maxb, and stale indices in the slots at or past each count. The plain
    version equals the Pallas kernel exactly: the flagged slots first, then
    every other slot, stale ones included, each in slot order."""
    s = _cloud(1000)
    ja, ta = _both(s)
    jr, jc = jpk.pack_contact_tables(*ja, tile_j=tile_j)
    tr, tc = tck.pack_contact_tables(*ta, tile_j=tile_j)
    nb, nb_j = tc.shape[1] // tck.TILE, tc.shape[1] // tile_j
    idx, cnt = edge_block_lists(nb, nb_j, nb_j, seed=tile_j + rest_filter)
    keep, filt = np.float32(s["rest_dist"] * 1.2), np.float32(s["filter_dist"])
    n = len(s["pos"])
    ji, jn = jpk.refine_overlap_blocks_packed(
        n, jr, jc, keep, filt, jnp.asarray(idx), jnp.asarray(cnt),
        interpret=True, rest_filter=rest_filter, tile_j=tile_j)
    ti, tn = tck.refine_overlap_blocks_packed(
        n, tr, tc, _f32(keep), _f32(filt), torch.as_tensor(idx),
        torch.as_tensor(cnt), rest_filter=rest_filter, tile_j=tile_j)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    assert (cnt == 0).any() and (cnt == nb_j).any()
    assert 0 < int(tn.sum()) < int(cnt.sum())  # the compaction reorders


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
    launch; a device that is neither CPU nor CUDA is refused, and so are
    inputs the kernels do not take."""
    s = _chain()
    _, ta = _both(s)
    _, (bidx, bcnt, _) = _blocks(s, 128)
    k1 = tck.block_sparse_contact_deltas_packed
    k2 = tck.refine_overlap_blocks_packed
    k3 = tck.dense_contact_deltas_packed
    before = (k1.launches, k1.fused_launches, k2.launches, k3.launches)
    rows, cols = tck.pack_contact_tables(*ta)
    shp = torch.zeros((1, 16))  # one plane at the origin
    shp[0, 0], shp[0, 1], shp[0, 11] = 2.0, 1.0, 1.0
    k1(512, rows, cols, _f32(0.04), _f32(0.25), _f32(0.0), bidx, bcnt)
    k1(512, rows, cols, _f32(0.04), _f32(0.25), _f32(0.0), bidx, bcnt,
       shp=shp, shape_params=(0.03, 0.0, 1.0, 1.0 / 720))
    k2(512, rows, cols, _f32(0.06), _f32(0.0), bidx, bcnt)
    k3(512, rows, cols, _f32(0.04), _f32(0.25), _f32(0.0))
    assert (k1.launches, k1.fused_launches, k2.launches,
            k3.launches) == before
    meta = [t.to("meta") for t in (rows, cols, bidx, bcnt)]
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k1(512, meta[0], meta[1], 0.04, 0.25, 0.0, meta[2], meta[3])
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        k3(512, meta[0], meta[1], 0.04, 0.25, 0.0)
    with pytest.raises(TypeError):
        k1(512, rows, cols, 0.04, 0.25, 0.0, bidx.long(), bcnt)
    with pytest.raises(ValueError, match="shape_params"):
        k1(512, rows, cols, 0.04, 0.25, 0.0, bidx, bcnt, shp=shp)
    with pytest.raises(ValueError, match="shared-memory"):
        k1(512, rows, cols, 0.04, 0.25, 0.0, bidx, bcnt,
           shp=torch.zeros((8, 16)), planes2d=torch.zeros((8 * 256, 4)),
           shape_params=(0.03, 0.0, 1.0, 1.0 / 720))
    with pytest.raises(ValueError, match="multiple of 128"):
        k3(512, rows[:100], cols[:, :100], 0.04, 0.25, 0.0)


def _dense_inputs():
    """The inputs of tests/test_pallas_kernels.py's dense test: 200 random
    particles, 8 groups, half of them self-colliding."""
    rng = np.random.RandomState(0)
    n = 200
    pos = rng.rand(n, 3).astype(np.float32) * 0.6
    return dict(pos=pos, prev=pos - rng.randn(n, 3).astype(np.float32) * 0.002,
                group=rng.randint(0, 8, n).astype(np.int32),
                inv_mass=(rng.rand(n) + 0.5).astype(np.float32),
                sc=rng.rand(n) > 0.5, active=np.ones(n, bool),
                rest=rng.rand(n, 3).astype(np.float32) * 0.6,
                rest_dist=0.08, friction=0.25, filter_dist=0.05)


def _granular_frame():
    """A granular frame: the dense band's scene (RandomState(3), granules
    in groups of their own, no self-collision) at a 1,024 cap: a row of
    granules along z about 0.086 apart, each moved 0.07 times its index
    back along z so that neighbours come within the contact distance,
    with a jitter of the substep-start positions."""
    from adaptigraph_torch.scenes.build import Caps
    from adaptigraph_torch.scenes.build import build_scene

    b = build_scene("granular", np.random.RandomState(3),
                    caps=Caps(n=1024, s=0, c=64, k=1024, m=8), device="cpu")
    p = b.state.particles
    pos = p.pos.numpy().copy()
    pos[:, 2] -= 0.07 * np.maximum(p.group.numpy(), 0)
    rng = np.random.RandomState(7)
    prm = b.spec.params
    return dict(pos=pos, prev=pos - rng.randn(*pos.shape).astype(np.float32)
                * 2e-3, group=p.group.numpy(), inv_mass=p.inv_mass.numpy(),
                sc=p.self_collide.numpy(), active=p.active.numpy(),
                rest=b.spec.rest_pos.numpy(),
                rest_dist=float(prm.solid_rest_distance),
                friction=float(prm.particle_friction),
                filter_dist=float(prm.collide_filter_dist))


_DENSE = {"pallas_test": _dense_inputs, "granular": _granular_frame,
          **_SCENES}


@pytest.mark.parametrize("scene", sorted(_DENSE))
def test_dense_sweep_plain_matches_pallas(scene):
    """K3's plain version against the JAX dense sweep: counts exact,
    deltas to 2e-5."""
    s = _DENSE[scene]()
    ja, ta = _both(s)
    scal = (s["rest_dist"], s["friction"], s["filter_dist"])
    jd, jc = jpk.dense_contact_deltas(*ja, *(jnp.float32(v) for v in scal),
                                      interpret=True)
    td, tc = tck.dense_contact_deltas(*ta, *(_f32(v) for v in scal))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert tc.sum() > 0
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=0, atol=2e-5)


def test_dense_sweep_equals_block_sweep_over_every_block():
    """K3 is K1 over a list of every col block with the rest filter on:
    the plain versions agree to rounding on the same tables."""
    s = _cloud()
    _, ta = _both(s)
    rows, cols = tck.pack_contact_tables(*ta)
    nb = cols.shape[1] // tck.TILE
    idx = torch.arange(nb, dtype=torch.int32).repeat(nb, 1)
    cnt = torch.full((nb,), nb, dtype=torch.int32)
    scal = [_f32(v) for v in (s["rest_dist"], s["friction"],
                              s["filter_dist"])]
    n = len(s["pos"])
    d1, c1 = tck.block_sparse_contact_deltas_packed(n, rows, cols, *scal, idx,
                                                    cnt)
    d3, c3 = tck.dense_contact_deltas_packed(n, rows, cols, *scal)
    assert torch.equal(c1, c3) and c3.sum() > 0
    torch.testing.assert_close(d1, d3, rtol=0, atol=1e-6)


def _shape_scene(shapes=FOUR_KINDS):
    """tests/test_pallas_kernels.py's fused-stage scene: 256 particles in
    groups of 16 (no self-collision) and random shape velocities, against
    a shape set of chip_smoke.py (make_shapes' arguments, its m_max and the
    active slot count): FOUR_KINDS, the Pallas test's floor plane, box,
    capsule and convex tetrahedron (one padding slot), or SEVEN_SLOTS."""
    from adaptigraph_tpu.engine import state as jstate

    rng = np.random.RandomState(3)
    n = 256
    pos = (rng.rand(n, 3).astype(np.float32) * 1.2
           - np.array([0.6, 0.0, 0.6], np.float32))
    sh = jstate.make_shapes(shapes["kinds"], shapes["sizes"],
                            shapes["poses"], shapes["quats"],
                            m_max=shapes["m_max"], planes=shapes["planes"])
    s = dict(pos=pos, prev=pos - rng.randn(n, 3).astype(np.float32) * 0.01,
             group=(np.arange(n) // 16).astype(np.int32),
             inv_mass=np.ones(n, np.float32), sc=np.zeros(n, bool),
             active=np.ones(n, bool), rest=rng.rand(n, 3).astype(np.float32),
             rest_dist=0.05, friction=0.25, filter_dist=0.0)
    a = shapes["active"]  # active shape slots
    s_vel = rng.randn(shapes["m_max"], 3).astype(np.float32) * 0.05
    shp = np.concatenate([
        np.asarray(sh.kind)[:a, None].astype(np.float32),
        np.asarray(sh.valid)[:a, None].astype(np.float32),
        np.asarray(sh.size)[:a], np.asarray(sh.pos)[:a],
        np.asarray(sh.quat)[:a], s_vel[:a], np.zeros((a, 1), np.float32)],
        axis=1)
    planes2d = np.array(sh.planes)[:a].reshape(-1, 4)
    return s, shp, planes2d, (0.04, 0.0, 0.3, 1.0 / 60)


def _fused_shape_stage_matches_pallas(rest_filter, tile_j,
                                      shapes=FOUR_KINDS):
    """The K1 wrapper with shape tables (K4's CPU form: the plain sweep
    plus shape_stage_plain) against the JAX fused K1 on _shape_scene's
    shape set: counts exact, deltas to 2e-5; every valid slot has
    contacts, an invalid one none."""
    s, shp, planes2d, sp = _shape_scene(shapes)
    ja, ta = _both(s)
    (jidx, jcnt, _), (tidx, tcnt, _) = _blocks(s, tile_j)
    jr, jc = jpk.pack_contact_tables(*ja, tile_j=tile_j)
    tr, tc = tck.pack_contact_tables(*ta, tile_j=tile_j)
    scal = (s["rest_dist"], s["friction"], s["filter_dist"])
    n = len(s["pos"])
    jd, jn = jpk.block_sparse_contact_deltas_packed(
        n, jr, jc, *scal, jidx, jcnt, interpret=True, rest_filter=rest_filter,
        tile_j=tile_j, shp=jnp.asarray(shp), planes2d=jnp.asarray(planes2d),
        shape_params=sp)
    td, tn = tck.block_sparse_contact_deltas_packed(
        n, tr, tc, *scal, tidx, tcnt, rest_filter=rest_filter, tile_j=tile_j,
        shp=torch.as_tensor(shp), planes2d=torch.as_tensor(planes2d),
        shape_params=sp)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=0, atol=2e-5)
    n_planes = planes2d.shape[0] // shp.shape[0]
    for k in range(shp.shape[0]):  # each valid slot alone meets particles
        pl = planes2d[n_planes * k:n_planes * (k + 1)]
        _, ck = tck.shape_stage_plain(tr[:n, 0:3], tr[:n, 3:6],
                                      torch.as_tensor(shp[k:k + 1]),
                                      torch.as_tensor(pl), *sp)
        assert (ck.sum() > 0) == (shp[k, 1] > 0.5), k


@pytest.mark.parametrize("rest_filter", [True, False])
@pytest.mark.parametrize("tile_j", [128, 256])
def test_fused_shape_stage_plain_matches_pallas(rest_filter, tile_j):
    """K4's CPU form against the JAX fused K1 on the four-kind shape set:
    counts exact, deltas to 2e-5; every kind has contacts."""
    _fused_shape_stage_matches_pallas(rest_filter, tile_j)


def test_fused_shape_stage_plain_matches_pallas_seven_slots():
    """The same on chip_smoke.SEVEN_SLOTS, the set the smoke holds K4's
    lane split to at a shape count that is not a multiple of its 4 lanes:
    7 active slots, one of them invalid, two of them convex (a tetrahedron
    padded to the cube's 6 planes, and the cube). In the design point's
    form only (tile_j 256, no rest filter): the interpreted JAX stage
    takes ~13 s a form at 7 shapes, and the four-kind test covers the
    forms."""
    assert SEVEN_SLOTS["active"] % 4 and SEVEN_SLOTS["kinds"].count(3) == 2
    _fused_shape_stage_matches_pallas(False, 256, SEVEN_SLOTS)


def test_shape_stage_plain_matches_the_unfused_pass():
    """shape_stage_plain (after _shape_stage's math) against the port's
    unfused pass collisions.shape_contact_deltas (after collisions.py's):
    the two round differently, so counts exact and deltas to 2e-5, as
    tests/test_pallas_kernels.py holds the two JAX forms."""
    from adaptigraph_torch.engine.collisions import shape_contact_deltas
    from adaptigraph_torch.engine.state import make_shapes

    s, shp, planes2d, (cd, margin, dyn, dt) = _shape_scene()
    kinds = shp[:, 0].astype(np.int32)
    quat = shp[:, 8:12]
    shapes = make_shapes(kinds, shp[:, 2:5], shp[:, 5:8], quat,
                         planes=[None, None, None, planes2d[12:16]],
                         device="cpu")
    pos, prev = torch.as_tensor(s["pos"]), torch.as_tensor(s["prev"])
    d0, c0 = shape_contact_deltas(
        pos, prev, shapes, shapes.pos, shapes.quat, torch.as_tensor(shp[:, 12:15]),
        _f32(cd), _f32(margin), _f32(dyn), _f32(dt))
    d1, c1 = tck.shape_stage_plain(pos, prev, torch.as_tensor(shp),
                                   torch.as_tensor(planes2d), cd, margin, dyn,
                                   dt)
    assert torch.equal(c0, c1) and c1.sum() > 0
    torch.testing.assert_close(d0, d1, rtol=0, atol=2e-5)


# --- the summation order of the redesigned sweep kernel (K1, and K3 as K1
# over full lists), emulated on the CPU

LANES = 4  # the sweep's lanes per row (kLanes in kernels/csrc/contact.cu)


def _rank_slots(cnt, rank, split):
    """The list slots rank `rank` of `split` sweeps in a row tile whose list
    holds `cnt`: rank, rank + split, ... below cnt, and how many the kernel
    counts for it."""
    mine = (cnt - rank + split - 1) // split if rank < cnt else 0
    return list(range(rank, cnt, split)), mine


def _kernel_order_sums(rows, cols, scal, block_idx, block_cnt, tile_j,
                       rest_filter, split):
    """Test-only emulation, in float32, of the order in which the sweep
    kernel adds the pair terms: rank s of a row tile's `split` ranks takes
    the list slots s, s + split, ...; lane l of a row takes the columns
    16 t + 4 l + q of each block, in that order; each thread adds its terms
    to 0 in that order; the lanes of a row combine as (l0 + l1) + (l2 + l3)
    and the ranks in rank order. Each pair's term is the plain version's
    (_pair_sums over one column). Returns (delta (n_pad, 3), count)."""
    tile = tck.TILE
    nb = cols.shape[1] // tile
    r = rows.view(nb, tile, 16)
    acc = torch.zeros((nb, split, LANES, tile, 4))
    for k in range(int(block_cnt.max())):
        live = (block_cnt > k)[:, None, None]
        blk = tck._gather_blocks(cols, block_idx, k, tile_j)
        for c in range(tile_j):
            term = tck._pair_sums(r, blk[:, :, c:c + 1], *scal,
                                  rest_filter).view(nb, tile, 4)
            acc[:, k % split, (c // 4) % LANES] += torch.where(live, term, 0.0)
    lanes = (acc[:, :, 0] + acc[:, :, 1]) + (acc[:, :, 2] + acc[:, :, 3])
    tot = lanes[:, 0]
    for s in range(1, split):
        tot = tot + lanes[:, s]
    tot = tot.reshape(-1, 4)
    return tot[:, :3], tot[:, 3]


# one scene per sweep form: the Pallas test's inputs through K3's form, the
# chain through K1 at tile_j 128, a granular frame through K1 at 256
_SPLIT_SCENES = {"dense": _dense_inputs, "block128": _chain,
                 "block256": _granular_frame}


@pytest.mark.parametrize("split", [1, 8])
@pytest.mark.parametrize("sweep", sorted(_SPLIT_SCENES))
def test_split_summation_order_matches_plain(sweep, split):
    """The pair sums added in the sweep kernel's order (strided slots over
    `split` ranks, 4 lanes a row, lanes then ranks combined in a fixed
    order) against the plain versions, at the fewest and the most ranks
    the card uses: counts exact, deltas within 2e-5, the tolerance the card
    is held to. The order of the kernel itself is held on the card (the
    smoke's kernel checks, full lists and repeated launches)."""
    s = _SPLIT_SCENES[sweep]()
    _, ta = _both(s)
    n = len(s["pos"])
    scal = [_f32(v) for v in (s["rest_dist"], s["friction"],
                              s["filter_dist"])]
    if sweep == "dense":
        tile_j, rest_filter = tck.TILE, True
        rows, cols = tck.pack_contact_tables(*ta)
        nbj = cols.shape[1] // tile_j
        idx = torch.arange(nbj, dtype=torch.int32).repeat(nbj, 1)
        cnt = torch.full((nbj,), nbj, dtype=torch.int32)
        pd, pc = tck.dense_contact_plain(n, rows, cols, *scal)
    else:
        tile_j, rest_filter = int(sweep[5:]), False
        rows, cols = tck.pack_contact_tables(*ta, tile_j=tile_j)
        _, (idx, cnt, _) = _blocks(s, tile_j)
        pd, pc = tck.block_sparse_contact_plain(
            n, rows, cols, *scal, idx, cnt, rest_filter=rest_filter,
            tile_j=tile_j)
    kd, kc = _kernel_order_sums(rows, cols, scal, idx, cnt, tile_j,
                                rest_filter, split)
    assert pc.sum() > 0
    assert torch.equal(kc[:n], pc)
    torch.testing.assert_close(kd[:n], pd, rtol=0, atol=2e-5)
    assert torch.equal(kc[n:], torch.zeros_like(kc[n:]))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_strided_slots_cover_every_listed_slot_once(split):
    """Ranks 0..split-1 taking slots rank, rank + split, ... cover every
    listed slot of every list length 0..maxb exactly once, and the
    kernel's count of a rank's slots matches."""
    for maxb in (1, 3, 8, 16, 40, 64, 128):
        for cnt in range(maxb + 1):
            taken = []
            for rank in range(split):
                slots, mine = _rank_slots(cnt, rank, split)
                assert mine == len(slots)
                taken += slots
            assert sorted(taken) == list(range(cnt))


def test_launch_geometry_reads_the_library():
    """kernels.build.launch_geometry passes the kernel (1, 2 or 3 for K1,
    K2, K3) and the shapes to ag_contact_geometry and names the four
    numbers it returns; a refused shape raises."""
    from adaptigraph_torch.kernels import build

    class Lib:
        def ag_contact_geometry(self, kernel, n_pad, maxb, out):
            if n_pad % 128:
                return 1
            split, lanes = {1: (2, 4), 2: (2, 4), 3: (8, 4)}[kernel]
            out[0], out[1] = n_pad // 128 * split, split
            out[2], out[3] = lanes, 128 * lanes
            return 0

        def ag_error_string(self, err):
            return b"invalid argument"

    assert build.launch_geometry(Lib(), "k3", 2048) == {
        "ctas": 128, "cluster": 8, "lanes": 4, "threads": 512}
    assert build.launch_geometry(Lib(), "k1", 5120, 40)["cluster"] == 2
    assert build.launch_geometry(Lib(), "k2", 5120, 40) == {
        "ctas": 80, "cluster": 2, "lanes": 4, "threads": 512}
    with pytest.raises(RuntimeError, match="ag_contact_geometry"):
        build.launch_geometry(Lib(), "k1", 100, 1)
    assert "ag_contact_geometry" in build.SIGNATURES


def test_kernel_turns_launches_match_the_c_signatures():
    """tools/kernel_turns.py's raw launches pass each C entry as many
    arguments as kernels.build.SIGNATURES declares, and write the outputs
    it compares (checked through a fake library: the tool needs a GPU)."""
    from adaptigraph_torch.kernels import build
    from adaptigraph_torch.tools import kernel_turns as kt

    class Lib:
        calls = []

        def __getattr__(self, fn):
            def entry(*args):
                assert len(args) == len(build.SIGNATURES[fn]), fn
                self.calls.append(fn)
                return 0
            return entry

    s = _chain()
    _, ta = _both(s)
    rows, cols = tck.pack_contact_tables(*ta)
    _, (idx, cnt, _) = _blocks(s, tck.TILE)
    a = dict(n=len(s["pos"]), rows=rows, cols=cols, idx=idx, cnt=cnt,
             ridx=idx, rcnt=cnt, tile_j=tck.TILE, rf=1, s1=torch.zeros(3),
             s2=torch.zeros(2))
    fused = dict(shp=torch.zeros((2, 16)), planes=None, n_shapes=2,
                 n_planes=0, s4=torch.zeros(7))
    dense, nb = kt._dense_cases(a["n"], rows, cols, torch.zeros(3), 0)
    lib = Lib()
    names = []
    for name, kernel, make in kt._cases(a, 0, fused) + dense:
        launch, outs = make(lib)
        launch()
        names.append((name, kernel))
        assert len(outs) == 2
    assert nb == cols.shape[1] // tck.TILE
    assert names == [("k1", "k1"), ("k1_fused", "k1"), ("k4_alone", "k1"),
                     ("k1_empty", "k1"), ("k2", "k2"), ("k3", "k3"),
                     ("k1_full_list", "k1")]
    assert Lib.calls == [
        "ag_block_sparse_contact", "ag_block_sparse_contact_shapes",
        "ag_block_sparse_contact_shapes", "ag_block_sparse_contact",
        "ag_refine_blocks", "ag_dense_contact", "ag_block_sparse_contact"]
    with pytest.raises(SystemExit, match="splits"):
        kt.main(["--base", "base.cu", "--splits", "3"])
