"""Port parity: the sparse contact mode (the fixed-K neighbor lists of
engine/neighbors.py and engine/cells.py, the per-frame contact invariants
and the neighbor-list contact pass) against the JAX package, and the
solver's interface settled with it: JAX's positional arguments
(`neighbor_k` after `iterations`) and pack_tables_for's contract.

Neighbor lists are held exactly, (idx, valid) array for array, on rope
lattices, whose distances tie: the top-k keeps lax.top_k's order (the
lower index first), over squared distances rounded as XLA rounds them on
the CPU (fused multiply-adds, engine/neighbors.sq_dist_fma; the plain sum
differs by an ulp on about half of all pairs, and then picks other
neighbors among ties). Frames: 3 frames of the 512-particle rope of
tests/test_torch_solver.py in sparse mode, every particle within 1e-4
(the rope's tolerance).
"""

import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptigraph_tpu.engine import cells as jcells
from adaptigraph_tpu.engine import neighbors as jnbr
from adaptigraph_tpu.engine import rollout_steps as j_rollout
from adaptigraph_tpu.engine import solver as jsol
from adaptigraph_tpu.engine import state as jstate
from adaptigraph_tpu.engine import xpbd_step as j_step
from adaptigraph_tpu.scenes import build_scene as j_build_scene
from adaptigraph_tpu.scenes.build import Caps as JCaps
from adaptigraph_torch.engine import cells, neighbors
from adaptigraph_torch.engine import solver as tsol
from adaptigraph_torch.engine import state as tstate
from adaptigraph_torch.engine.contact_kernels import pack_contact_tables
from adaptigraph_torch.engine.solver import rollout_steps, xpbd_step

_T = 3
_ATOL = 1e-4
_SPACING = 0.03


def _lattice(shape, origin, drop=0, seed=0):
    """A cubic lattice at the rope's particle spacing (every neighbor
    distance ties with others), its order shuffled, and `drop` particles
    inactive."""
    g = np.stack(np.meshgrid(*(np.arange(s) for s in shape), indexing="ij"),
                 -1).reshape(-1, 3)
    pos = (g * _SPACING + np.asarray(origin)).astype(np.float32)
    rng = np.random.RandomState(seed)
    pos = pos[rng.permutation(len(pos))]
    active = np.ones(len(pos), bool)
    active[rng.choice(len(pos), drop, replace=False)] = False
    return pos, active


def _rope_positions():
    """The 512-cap rope's positions and active mask (the sampler's draw for
    RandomState(0), bench.py's overrides): a rotated lattice."""
    b = j_build_scene("rope", np.random.RandomState(0),
                      caps=JCaps(n=512, s=0, c=128, k=640, m=2),
                      scene_overrides={"length": 6.0, "z_rotation": 0.0,
                                       "y_rotation": 90.0})
    return (np.asarray(b.state.particles.pos),
            np.asarray(b.state.particles.active))


def _both(jfn, tfn, pos, active, radius, **kw):
    j = jfn(jnp.asarray(pos), jnp.float32(radius), jnp.asarray(active), **kw)
    t = tfn(torch.as_tensor(pos), torch.tensor(radius, dtype=torch.float32),
            torch.as_tensor(active), **kw)
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


@pytest.mark.parametrize("k", [6, 8, 24])
@pytest.mark.parametrize("scene", ["lattice", "rope"])
def test_neighbor_list_matches_jax(scene, k):
    """neighbor_list (the sparse mode's find up to 1,024 particles) at the
    solver's radius (1.5 x spacing): k = 6 and 8 cut inside a tie (a
    lattice point has 6 neighbors at the spacing and 12 at its diagonal),
    24 keeps every neighbor."""
    if scene == "lattice":
        pos, active = _lattice((8, 8, 8), (-0.1, 0.2, -0.05), drop=20)
    else:
        pos, active = _rope_positions()
    (ji, jv), (ti, tv) = _both(jnbr.neighbor_list, neighbors.neighbor_list,
                               pos, active, 1.5 * _SPACING, k=k)
    assert ti.dtype == np.int32 and tv.dtype == bool
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    assert tv.sum(1).max() == min(k, 18)  # ties were cut or kept whole


@pytest.mark.parametrize("k", [8, 24])
@pytest.mark.parametrize("scene", ["lattice", "jittered"])
def test_cell_list_matches_jax(scene, k):
    """cell_list_neighbors (the sparse mode's find above 1,024 particles)
    on 1,728 lattice points straddling the origin (negative cells hash
    through the wrapped products), and on the same points jittered by up
    to a fifth of the spacing; cell_bucket_overflow as well (buckets
    overflow here: cells of 1.5 spacings hold up to 8 lattice points, and
    cells that alias to one hash row share a bucket)."""
    pos, active = _lattice((12, 12, 12), (-0.17, -0.05, -0.2), drop=40)
    if scene == "jittered":
        rng = np.random.RandomState(3)
        pos = (pos + rng.uniform(-0.2, 0.2, pos.shape) * _SPACING).astype(
            np.float32)
    radius = 1.5 * _SPACING
    (ji, jv), (ti, tv) = _both(jcells.cell_list_neighbors,
                               cells.cell_list_neighbors, pos, active, radius,
                               k=k)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    assert tv.any(axis=1).sum() > 1500
    overflow = []
    for bucket in (2, 8):
        j = jcells.cell_bucket_overflow(jnp.asarray(pos), jnp.float32(radius),
                                        jnp.asarray(active),
                                        bucket_size=bucket)
        t = cells.cell_bucket_overflow(torch.as_tensor(pos),
                                       torch.tensor(radius),
                                       torch.as_tensor(active),
                                       bucket_size=bucket)
        assert int(t) == int(j)
        overflow.append(int(t))
    assert overflow[0] > overflow[1]  # buckets of 2 drop more


@pytest.fixture(scope="module")
def rope():
    """tests/test_torch_solver.py's rope: 512 particles lifted to the
    sampler's height, the box pusher sweeping into it."""
    shapes = jstate.make_shapes([jstate.SHAPE_PLANE, jstate.SHAPE_BOX],
                                [[0, 0, 0], [0.05, 0.4, 0.8]],
                                [[0, 0, 0], [0, 0.4, 0]],
                                [[0, 0, 0, 1], [0, 0, 0, 1]], m_max=2)
    b = j_build_scene("rope", np.random.RandomState(0), shapes=shapes,
                      caps=JCaps(n=512, s=0, c=128, k=640, m=2),
                      scene_overrides={"length": 6.0, "z_rotation": 0.0,
                                       "y_rotation": 90.0,
                                       "translation": np.array([0, 0.5, 0])})
    st = b.state
    center = np.asarray(st.particles.pos)[: b.n_active].mean(0)
    pos_traj = np.tile(np.asarray(st.shapes.pos)[None], (_T, 1, 1))
    pos_traj[:, 1, 0] = np.linspace(center[0] - 0.12, center[0] - 0.06, _T)
    pos_traj[:, 1, 1] = 0.35
    pos_traj[:, 1, 2] = center[2]
    quat_traj = np.tile(np.asarray(st.shapes.quat)[None], (_T, 1, 1))
    return b, pos_traj.astype(np.float32), quat_traj.astype(np.float32)


def _port(state, spec):
    return tstate.scene_from_numpy(tstate.tree_to_numpy(state),
                                   tstate.tree_to_numpy(spec), "cpu")


def test_sparse_frames_match_jax(rope):
    """3 sparse frames, both sides from the same state; the neighbor
    list's pairs meet (the pusher presses the rope)."""
    b, pos_traj, quat_traj = rope
    jf, jrec = j_rollout(b.state, b.spec, jnp.asarray(pos_traj),
                         jnp.asarray(quat_traj), substeps=b.substeps,
                         iterations=b.iterations, contact_mode="sparse")
    ts, tspec = _port(b.state, b.spec)
    tf, trec = rollout_steps(ts, tspec, pos_traj, quat_traj, b.substeps,
                             b.iterations, contact_mode="sparse")
    per_particle = np.abs(trec.numpy() - np.asarray(jrec)).max(axis=(0, 2))
    assert per_particle.max() <= _ATOL, per_particle.max()
    np.testing.assert_allclose(tf.cluster_rot.numpy(),
                               np.asarray(jf.cluster_rot), rtol=0, atol=_ATOL)
    # the contact pass acts: eligible pairs in contact at the last frame
    idx, elig, share = tsol.frame_neighbors(tf.particles, tspec, 24)
    d = tf.particles.pos[:, None, :] - tf.particles.pos[idx.long()]
    close = torch.linalg.vector_norm(d, dim=-1) < tspec.params.solid_rest_distance
    assert int((elig & close).sum()) > 0


def test_contact_invariants_match_jax(rope):
    """precompute_contact_static (eligibility, mass shares) and the
    neighbor-list contact pass on the rope, with a few particles pinned
    and moved positions, against JAX (shares and deltas to 1e-6)."""
    b, _, _ = rope
    p = b.state.particles
    rng = np.random.RandomState(2)
    pos = np.asarray(p.pos) + rng.randn(*p.pos.shape).astype(np.float32) * 4e-3
    prev = pos - rng.randn(*p.pos.shape).astype(np.float32) * 2e-3
    inv_mass = np.asarray(p.inv_mass) * (rng.rand(p.pos.shape[0]) > 0.1)
    prm = b.spec.params
    radius = float(np.float32(prm.radius) * np.float32(1.5))
    jidx, jvalid = jnbr.neighbor_list(jnp.asarray(pos), jnp.float32(radius),
                                      p.active, k=24)
    je, js = jsol.precompute_contact_static(
        jnp.asarray(inv_mass, jnp.float32), p.group, p.self_collide, p.active,
        jidx, jvalid, rest_pos=b.spec.rest_pos,
        filter_dist=prm.collide_filter_dist)
    jd, jc = jsol._particle_contact_deltas(
        jnp.asarray(pos), jnp.asarray(prev), jidx, je, js,
        prm.solid_rest_distance, prm.particle_friction)
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    tidx, tvalid = neighbors.neighbor_list(t(pos), torch.tensor(radius),
                                           t(p.active), k=24)
    te, tsh = tsol.precompute_contact_static(
        t(inv_mass.astype(np.float32)), t(p.group), t(p.self_collide),
        t(p.active), tidx, tvalid, rest_pos=t(b.spec.rest_pos),
        filter_dist=t(prm.collide_filter_dist))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tsh.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    td, tc = tsol._particle_contact_deltas(
        t(pos), t(prev), tidx, te, tsh, t(prm.solid_rest_distance),
        t(prm.particle_friction))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert float(tc.sum()) > 0


def test_solver_arguments_are_jax_positions(rope):
    """xpbd_step and rollout_steps take JAX's positional arguments up to
    `neighbor_k`, right after `iterations`, and every parameter after it
    by keyword only. A JAX-style call rollout_steps(s, spec, p, q, 2, 4,
    24) sets neighbor_k = 24 and keeps the recording, and a JAX-style
    xpbd_step call that passes JAX's `dense_contacts` positionally fails
    instead of binding it to another parameter."""
    for j, t in ((jsol.xpbd_step, xpbd_step),
                 (jsol.rollout_steps, rollout_steps)):
        jp = list(inspect.signature(j).parameters)
        tsig = inspect.signature(t).parameters
        pos = [k for k, v in tsig.items()
               if v.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
        assert pos == jp[:jp.index("neighbor_k") + 1], (pos, jp)
        assert all(v.kind is inspect.Parameter.KEYWORD_ONLY
                   for k, v in tsig.items() if k not in pos)
        assert set(tsig) <= set(jp), (list(tsig), jp)
    b, pos_traj, quat_traj = rope
    ts, tspec = _port(b.state, b.spec)
    _, rec_pos = rollout_steps(ts, tspec, pos_traj[:1], quat_traj[:1], 2, 4,
                               6)
    _, rec_kw = rollout_steps(ts, tspec, pos_traj[:1], quat_traj[:1], 2, 4,
                              neighbor_k=6, record=True)
    assert rec_pos is not None and torch.equal(rec_pos, rec_kw)
    st = ts._replace(shapes=ts.shapes.moved_to(torch.as_tensor(pos_traj[0]),
                                               torch.as_tensor(quat_traj[0])))
    with pytest.raises(TypeError):
        xpbd_step(st, tspec, 2, 4, 6, False)
    c = xpbd_step(st, tspec, 2, 4, 6, contact_mode="sparse")
    jst = b.state._replace(shapes=b.state.shapes.moved_to(
        jnp.asarray(pos_traj[0]), jnp.asarray(quat_traj[0])))
    jout = j_step(jst, b.spec, 2, 4, 6, False)
    np.testing.assert_allclose(c.particles.pos.numpy(),
                               np.asarray(jout.particles.pos), rtol=0,
                               atol=_ATOL)


@pytest.mark.parametrize("n_active", [512, 2600])
def test_pack_tables_for_follows_the_auto_mode(n_active):
    """pack_tables_for(particles, spec) packs only where the auto contact
    mode is 'block' (above 2,048 particles), at auto_tile_j, as the JAX
    version does; elsewhere it returns None, as JAX's does."""
    rng = np.random.RandomState(0)
    pos = rng.rand(n_active, 3).astype(np.float32)
    jp = jstate.make_particles(pos, self_collide=True)
    tp = tstate.make_particles(pos, self_collide=True)
    rest = np.zeros((n_active, 3), np.float32)
    jspec = type("Spec", (), {"rest_pos": jnp.asarray(rest)})
    tspec = type("Spec", (), {"rest_pos": torch.as_tensor(rest)})
    jt, tt = jsol.pack_tables_for(jp, jspec), tsol.pack_tables_for(tp, tspec)
    if n_active <= 2048:
        assert jt is None and tt is None
        return
    want = pack_contact_tables(tp.pos, tp.pos, tp.group, tp.inv_mass,
                               tp.self_collide, tp.active, tspec.rest_pos,
                               tile_j=tsol.auto_tile_j(n_active))
    for a, b in zip(tt, want):
        assert torch.equal(a, b)
    assert tt[1].shape == tuple(np.asarray(jt[1]).shape)
    np.testing.assert_array_equal(tt[1].numpy(), np.asarray(jt[1]))
