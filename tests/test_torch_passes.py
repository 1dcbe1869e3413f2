"""Port parity: the frame's remaining passes against the JAX package: the
gather cluster pass in its incidence-gather and scatter forms, plastic
flow, and `cluster_rest` carried through the frame (a set cluster_rest
routes the cluster pass to the gather form even where a matmul layout
exists).

Tolerances: a pass on the same inputs 1e-5 (float32 sums in another
order, six polar iterations); frames 1e-4 (the rope's tolerance,
tests/test_torch_solver.py); the plasticity scenario of
tests/test_engine.py to its own bounds, and to JAX's extents within 1e-3
after 90 frames of stretching and release.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptigraph_tpu.engine import rollout_steps as j_rollout
from adaptigraph_tpu.engine import solver as jsol
from adaptigraph_tpu.engine import state as jstate
from adaptigraph_tpu.engine import xpbd_step as j_step
from adaptigraph_tpu.scenes import build_scene as j_build_scene
from adaptigraph_tpu.scenes.build import Caps as JCaps
from adaptigraph_torch.engine import solver as tsol
from adaptigraph_torch.engine import state as tstate
from adaptigraph_torch.engine.solver import rollout_steps, xpbd_step

_T = 3
_ATOL = 1e-4


def _port(state, spec):
    return tstate.scene_from_numpy(tstate.tree_to_numpy(state),
                                   tstate.tree_to_numpy(spec), "cpu")


def _chain(n=80, seed=7, incidence=False):
    """tests/test_solver_paths.py's spring-and-cluster scene (JAX-built):
    a chain of springs and overlapping clusters, no incidence tables (the
    scatter forms) or both (the gather forms)."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 3).astype(np.float32) * 0.5 + np.array([0, 0.3, 0],
                                                             np.float32)
    p = jstate.make_particles(pts, group=np.arange(n) % 10)
    shapes = jstate.make_shapes([jstate.SHAPE_PLANE], [[0, 0, 0]],
                                [[0, 0, 0]], [[0, 0, 0, 1]], m_max=2)
    idx = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    springs = jstate.make_springs(idx, rest=0.05, stiffness=0.4,
                                  capacity=n + 10)
    members = [list(range(i, min(i + 6, n))) for i in range(0, n, 4)]
    clusters = jstate.make_clusters(members, pts, 0.3,
                                    c_max=len(members) + 2, k_max=8)
    spec = jstate.SceneSpec(
        springs=springs, clusters=clusters,
        global_stiffness=jnp.float32(0.0), global_rest=jnp.zeros((0, 3)),
        rest_pos=jnp.zeros((n, 3)),
        params=jstate.SolverParams(radius=jnp.float32(0.08),
                                   solid_rest_distance=jnp.float32(0.08),
                                   gravity=jnp.float32(-10.0)))
    if incidence:
        spec = spec._replace(
            spring_inc=jstate.build_spring_incidence(springs, n),
            cluster_inc=jstate.build_cluster_incidence(clusters, n))
    st = jstate.SceneState(
        particles=p, shapes=shapes,
        cluster_rot=jnp.tile(jnp.array([0.0, 0, 0, 1.0]),
                             (len(members) + 2, 1)),
        global_rot=jnp.array([0.0, 0, 0, 1]))
    return st, spec


@pytest.mark.parametrize("form", ["scatter", "gather"])
def test_spring_and_cluster_forms_match_jax(form):
    """tests/test_solver_paths.py:128-146's scene, 8 frames (dense
    contacts, the auto mode) on both sides, in the scatter forms of the
    spring and cluster passes or in their incidence-gather forms."""
    jst, jspec = _chain(incidence=form == "gather")
    ts, tspec = _port(jst, jspec)
    assert (tspec.spring_inc is None) == (form == "scatter")
    assert tspec.cluster_mm is None and tspec.cluster_seg is None
    for _ in range(8):
        jst = j_step(jst, jspec, 2, 4)
        ts = xpbd_step(ts, tspec, 2, 4)
    np.testing.assert_allclose(ts.particles.pos.numpy(),
                               np.asarray(jst.particles.pos), rtol=0,
                               atol=_ATOL)
    np.testing.assert_allclose(ts.cluster_rot.numpy(),
                               np.asarray(jst.cluster_rot), rtol=0,
                               atol=_ATOL)
    assert float((ts.particles.pos[:, 1] - 0.3).min()) < 0.0  # it fell


@pytest.fixture(scope="module")
def rope():
    """The 512-cap rope (RandomState(0), bench.py's overrides, lifted),
    with its incidence, matmul and JAX-built state."""
    shapes = jstate.make_shapes([jstate.SHAPE_PLANE, jstate.SHAPE_BOX],
                                [[0, 0, 0], [0.05, 0.4, 0.8]],
                                [[0, 0, 0], [0, 0.4, 0]],
                                [[0, 0, 0, 1], [0, 0, 0, 1]], m_max=2)
    return j_build_scene("rope", np.random.RandomState(0), shapes=shapes,
                         caps=JCaps(n=512, s=0, c=128, k=640, m=2),
                         scene_overrides={"length": 6.0, "z_rotation": 0.0,
                                          "y_rotation": 90.0,
                                          "translation": np.array([0, 0.5,
                                                                   0])})


def _moved(b, seed=5):
    """The rope's rest positions rotated, shifted and jittered, and
    warm-start rotations: a deformation the cluster pass pulls back."""
    rng = np.random.RandomState(seed)
    rest = np.asarray(b.spec.rest_pos)
    c, s_ = np.cos(0.2), np.sin(0.2)
    rot = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
    pos = (rest @ rot.T + 0.1 + rng.randn(*rest.shape) * 1e-2).astype(
        np.float32)
    q = rng.randn(b.spec.clusters.valid.shape[0], 4).astype(np.float32) * 0.05
    q[:, 3] = 1.0
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return pos, q


@pytest.mark.parametrize("form", ["gather", "scatter"])
def test_cluster_pass_matches_jax(rope, form):
    """_cluster_deltas on the rope's overlapping ball cover, through its
    incidence table or by scatter, with rest offsets from a plastic
    state (the spec's, scaled), against the JAX pass (1e-5)."""
    pos, q = _moved(rope)
    _, tspec = _port(rope.state, rope.spec)
    jrest = rope.spec.clusters.rest * 1.05
    jinc = rope.spec.cluster_inc if form == "gather" else None
    tinc = tspec.cluster_inc if form == "gather" else None
    assert tinc is not None or form == "scatter"
    j = jsol._cluster_deltas(jnp.asarray(pos), rope.spec.clusters,
                             jnp.asarray(q), rest=jrest, inc=jinc)
    t = tsol._cluster_deltas(torch.as_tensor(pos), tspec.clusters,
                             torch.as_tensor(q),
                             rest=torch.as_tensor(np.asarray(jrest)), inc=tinc)
    for a, b in zip(j, t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-5)
    assert float(t[0].abs().max()) > 0.01 and float(t[1].sum()) > 0


def test_plastic_flow_matches_jax(rope):
    """_plastic_flow on the deformed rope: the clusters past the threshold
    take `creep` of their deviation into their rest offsets, re-centred
    (1e-6)."""
    pos, q = _moved(rope)
    _, tspec = _port(rope.state, rope.spec)
    cl = rope.spec.clusters
    j = jsol._plastic_flow(jnp.asarray(pos), cl, jnp.asarray(q), cl.rest,
                           jnp.float32(0.004), jnp.float32(0.3))
    t = tsol._plastic_flow(torch.as_tensor(pos), tspec.clusters,
                           torch.as_tensor(q), tspec.clusters.rest,
                           torch.tensor(0.004), torch.tensor(0.3))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
    moved = (t - tspec.clusters.rest).abs().amax(dim=(1, 2))
    assert 0 < int((moved > 1e-4).sum()) < int(tspec.clusters.valid.sum())


@pytest.mark.parametrize("mode", ["dense", "block"])
def test_cluster_rest_frames_match_jax(rope, mode):
    """3 frames of the rope with plastic flow on (cluster_rest seeded from
    the spec, threshold 0.002, creep 0.3) on both sides: the cluster pass
    leaves the membership matrix for the gather form, and the new rest
    offsets come back in the state (1e-4)."""
    b = rope
    jspec = b.spec._replace(params=b.spec.params._replace(
        plastic_threshold=jnp.float32(0.002), plastic_creep=jnp.float32(0.3)))
    jst = b.state._replace(cluster_rest=jnp.array(b.spec.clusters.rest))
    center = np.asarray(jst.particles.pos)[: b.n_active].mean(0)
    pos_traj = np.tile(np.asarray(jst.shapes.pos)[None], (_T, 1, 1))
    pos_traj[:, 1, 0] = np.linspace(center[0] - 0.12, center[0] - 0.06, _T)
    pos_traj[:, 1, 1] = 0.35
    pos_traj[:, 1, 2] = center[2]
    quat_traj = np.tile(np.asarray(jst.shapes.quat)[None], (_T, 1, 1))
    jf, jrec = j_rollout(jst, jspec, jnp.asarray(pos_traj),
                         jnp.asarray(quat_traj), substeps=b.substeps,
                         iterations=b.iterations, contact_mode=mode)
    ts, tspec = _port(jst, jspec)
    assert tspec.cluster_mm is not None and ts.cluster_rest is not None
    tf, trec = rollout_steps(ts, tspec, pos_traj, quat_traj, b.substeps,
                             b.iterations, contact_mode=mode)
    np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), rtol=0,
                               atol=_ATOL)
    np.testing.assert_allclose(tf.cluster_rest.numpy(),
                               np.asarray(jf.cluster_rest), rtol=0,
                               atol=_ATOL)
    flowed = (tf.cluster_rest - tspec.clusters.rest).abs().max()
    assert float(flowed) > 1e-4  # the rest offsets took some flow


def _plastic_scene(mod, plastic, start, inv_mass):
    """tests/test_engine.py's plasticity case in `mod`'s package: three
    particles, one cluster, stiffness 0.5, threshold 0.02, creep 0.3, no
    gravity, a floor."""
    rest_pts = np.array([[0.0, 0, 0], [0.5, 0, 0], [1.0, 0, 0]], np.float32)
    if mod is jstate:
        clusters = jstate.make_clusters([[0, 1, 2]], rest_pts, stiffness=0.5,
                                        c_max=2, k_max=4)
        spec = jstate.SceneSpec(
            springs=jstate.empty_springs(4), clusters=clusters,
            global_stiffness=jnp.float32(0.0),
            global_rest=jnp.zeros((3, 3), jnp.float32),
            rest_pos=jnp.zeros((3, 3), jnp.float32),
            params=jstate.SolverParams(gravity=jnp.float32(0.0),
                                       plastic_threshold=jnp.float32(0.02),
                                       plastic_creep=jnp.float32(0.3)))
        rot = jnp.tile(jnp.array([0.0, 0, 0, 1.0]), (2, 1))
        st = jstate.SceneState(
            particles=jstate.make_particles(start, inv_mass=inv_mass),
            shapes=jstate.make_shapes([jstate.SHAPE_PLANE], [[0, 0, 0]],
                                      [[0, 0, 0]], [[0, 0, 0, 1]], m_max=4),
            cluster_rot=rot, global_rot=jnp.array([0.0, 0, 0, 1.0]),
            cluster_rest=jnp.array(clusters.rest) if plastic else None)
        return st, spec
    clusters = tstate.make_clusters([[0, 1, 2]], rest_pts, stiffness=0.5,
                                    c_max=2, k_max=4)
    spec = tstate.SceneSpec(
        springs=tstate.empty_springs(4), clusters=clusters,
        global_stiffness=torch.zeros(()), global_rest=torch.zeros((3, 3)),
        rest_pos=torch.zeros((3, 3)),
        params=tstate.make_params("cpu", gravity=0.0, plastic_threshold=0.02,
                                  plastic_creep=0.3))
    st = tstate.SceneState(
        particles=tstate.make_particles(start, inv_mass=inv_mass),
        shapes=tstate.make_shapes([tstate.SHAPE_PLANE], [[0, 0, 0]],
                                  [[0, 0, 0]], [[0, 0, 0, 1]], m_max=4),
        cluster_rot=torch.tensor([[0.0, 0, 0, 1.0]] * 2),
        global_rot=torch.tensor([0.0, 0, 0, 1.0]),
        cluster_rest=clusters.rest.clone() if plastic else None)
    return st, spec


def _plastic_run(mod, step, plastic):
    """Hold both ends in the stretched pose for 30 frames, release the far
    end for 60: the cluster's extent and final rest offsets."""
    start = np.array([[0.0, 0, 0], [0.5, 0, 0], [1.8, 0, 0]], np.float32)
    st, spec = _plastic_scene(mod, plastic, start,
                              np.array([0.0, 1.0, 0.0], np.float32))
    for _ in range(30):
        st = step(st, spec, 2, 6)
    held = np.asarray(st.particles.pos)[:3]
    released, _ = _plastic_scene(mod, False, held,
                                 np.array([0.0, 1.0, 1.0], np.float32))
    st = st._replace(particles=released.particles)
    for _ in range(60):
        st = step(st, spec, 2, 6)
    pos = np.asarray(st.particles.pos)
    rest = None if st.cluster_rest is None else np.asarray(st.cluster_rest)
    return float(np.linalg.norm(pos[2] - pos[0])), rest


def test_plasticity_absorbs_deformation_on_the_port():
    """tests/test_engine.py:229-268 on the port: the elastic cluster snaps
    back to its rest extent, the plastic one keeps a permanent set, its
    rest shape stretched and re-centred; the extents and rest offsets as
    JAX's (1e-3 after 90 frames)."""
    elastic, _ = _plastic_run(tstate, xpbd_step, False)
    plastic, rest = _plastic_run(tstate, xpbd_step, True)
    assert elastic == pytest.approx(1.0, abs=2e-2)
    assert plastic > 1.3
    assert np.ptp(rest[0, :3, 0]) > 1.3
    np.testing.assert_allclose(rest[0, :3].mean(0), 0.0, atol=1e-5)
    j_elastic, _ = _plastic_run(jstate, j_step, False)
    j_plastic, j_rest = _plastic_run(jstate, j_step, True)
    assert abs(elastic - j_elastic) < 1e-3 and abs(plastic - j_plastic) < 1e-3
    np.testing.assert_allclose(rest, j_rest, rtol=0, atol=1e-3)
