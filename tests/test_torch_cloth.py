"""Port parity: the cloth frame against the JAX package: the sampler and
builder (the grid's springs turned into static-offset families, the
springs left over into an incidence table), the three spring passes, the
frame in the dense and block contact modes, and the design point's
launch counts. The JAX Pallas kernels run in interpret mode, as the JAX
package's own tests run them.

Tolerances:
- builder and spring topology: every array exact (both sides are the same
  host numpy calls; the float arrays are copied, not recomputed);
- spring passes: 1e-6 (float32 sums of a few terms in another order);
- 3 frames of a reduced sheet (24 x 24 particles in Caps(n=640, s=4096,
  c=0, k=0, m=2), 2 substeps x 10 iterations, its positions jittered by up
  to 0.006 in x and z so that particle contacts act, the box pushing its
  edge): every particle within 1e-4, the rope's tolerance
  (tests/test_torch_solver.py; observed ~1e-7).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptigraph_tpu.engine import rollout_steps as j_rollout
from adaptigraph_tpu.engine import solver as jsol
from adaptigraph_tpu.engine import state as jstate
from adaptigraph_tpu.scenes import build as jbuild
from adaptigraph_tpu.scenes import build_scene as j_build_scene
from adaptigraph_torch.engine import contact_kernels as tck
from adaptigraph_torch.engine import solver as tsol
from adaptigraph_torch.engine import state as tstate
from adaptigraph_torch.engine.solver import rollout_steps
from adaptigraph_torch.scenes import build as tbuild
from adaptigraph_torch.scenes import build_scene
from adaptigraph_torch.scenes import design_point as dp

_T = 3
_ATOL = 1e-4
_SMALL = (640, 4096, 0, 0, 2)
_SCHEDULE = (2, 10)  # substeps, iterations of the reduced frames


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _assert_exact(jt, tt, what):
    jf, tf = _flat(tstate.tree_to_numpy(jt)), _flat(tstate.tree_to_numpy(tt))
    assert sorted(jf) == sorted(tf), what
    for key in jf:
        a, b = jf[key], tf[key]
        if a is None or b is None:
            assert a is None and b is None, f"{what}.{key}"
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{what}.{key}"
        if a.ndim == 0 and a.dtype.kind == "f":
            # solver parameters: the JAX defaults are Python floats, the
            # port's float32
            np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=key)
            continue
        assert a.dtype == b.dtype, f"{what}.{key}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{key}")


@pytest.mark.parametrize("seed", [0, 1])
def test_cloth_builder_matches_jax(seed):
    """The full 70 x 70 sheet at the material's caps, array for array: six
    offset families (1, 70, 69, 71, 2, 140, in the JAX builder's order),
    their tables exact, no spring left over, so no incidence table."""
    jb = j_build_scene("cloth", np.random.RandomState(seed))
    tb = build_scene("cloth", np.random.RandomState(seed), device="cpu")
    assert (tb.n_active, tb.substeps, tb.iterations) == (
        jb.n_active, jb.substeps, jb.iterations) == (4900, 4, 50)
    assert tb.props == jb.props
    _assert_exact(jb.state, tb.state, "state")
    _assert_exact(jb.spec, tb.spec, "spec")
    os_ = tb.spec.offset_springs
    assert os_.offsets == jb.spec.offset_springs.offsets == (
        1, 70, 69, 71, 2, 140)
    # 4,830 + 4,760 + 2 x 4,761 + 4,830 + 4,760 grid springs
    assert int(os_.valid.sum()) == 28_702
    assert tb.spec.springs.idx.shape == (0, 2)
    assert tb.spec.spring_inc is None and tb.spec.cluster_inc is None
    assert bool(tb.state.particles.self_collide[:4900].all())


def _chain_scene(mod, mixed: bool, n=80, seed=7):
    """tests/test_solver_paths.py's spring-and-cluster scene (a chain of
    springs and overlapping clusters), built by `mod`'s state module; with
    `mixed`, 40 random irregular springs (duplicates and a degenerate one
    included) join the chain."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 3).astype(np.float32) * 0.5 + np.array([0, 0.3, 0],
                                                             np.float32)
    idx = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    rest = np.full(n - 1, 0.05, np.float32)
    if mixed:
        extra = rng.randint(0, n, (40, 2))
        extra[-1] = [5, 5]  # degenerate
        extra[-2] = extra[-3]  # duplicate slot
        idx = np.concatenate([idx, extra])
        rest = np.concatenate([rest, rng.rand(40).astype(np.float32) * 0.2])
    members = [list(range(i, min(i + 6, n))) for i in range(0, n, 4)]
    kw = {} if mod is jstate else {"device": "cpu"}
    springs = mod.make_springs(idx, rest=rest, stiffness=0.4,
                               capacity=len(idx) + 10, **kw)
    clusters = mod.make_clusters(members, pts, 0.3, c_max=len(members) + 2,
                                 k_max=8, **kw)
    return pts, springs, clusters


def _chain_spec(mod, mixed):
    """(points, spec) of _chain_scene in `mod`'s package."""
    pts, springs, clusters = _chain_scene(mod, mixed)
    n = len(pts)
    if mod is jstate:
        return pts, jstate.SceneSpec(
            springs=springs, clusters=clusters,
            global_stiffness=jnp.float32(0.0), global_rest=jnp.zeros((0, 3)),
            rest_pos=jnp.zeros((n, 3)),
            params=jstate.SolverParams(radius=jnp.float32(0.08),
                                       solid_rest_distance=jnp.float32(0.08),
                                       gravity=jnp.float32(-10.0)))
    return pts, tstate.SceneSpec(
        springs=springs, clusters=clusters,
        global_stiffness=torch.zeros(()), global_rest=torch.zeros((0, 3)),
        rest_pos=torch.zeros((n, 3)),
        params=tstate.make_params("cpu", radius=0.08, solid_rest_distance=0.08,
                                  gravity=-10.0))


@pytest.mark.parametrize("mixed", [False, True], ids=["chain", "mixed"])
def test_spring_topology_matches_jax(mixed):
    """attach_incidence on both sides: the families (the chain converts
    fully into one; the mixed set fills the 12 families the rule allows,
    the order of equal counts set by numpy's unstable argsort, the same
    call on both sides), the springs left over, their incidence table and
    the cluster incidence, exact."""
    _, jspec = _chain_spec(jstate, mixed)
    _, tspec = _chain_spec(tstate, mixed)
    jspec = jbuild.attach_incidence(jspec, 80)
    tspec = tbuild.attach_incidence(tspec, 80)
    _assert_exact(jspec, tspec, "spec")
    offsets = tspec.offset_springs.offsets
    if mixed:
        assert len(offsets) == 12 and offsets[0] == 1
        assert tspec.springs.idx.shape[0] > 0
        assert tspec.spring_inc is not None
    else:
        assert offsets == (1,) and tspec.springs.idx.shape[0] == 0
        assert tspec.spring_inc is None


def _spring_inputs(seed=2):
    """The mixed spring set on both sides (as a SpringSet, its incidence
    table and its offset families) and random positions and masses (a few
    pinned)."""
    _, jspec = _chain_spec(jstate, True)
    _, tspec = _chain_spec(tstate, True)
    rng = np.random.RandomState(seed)
    pos = rng.rand(80, 3).astype(np.float32) * 0.4
    inv_mass = np.where(rng.rand(80) < 0.15, 0.0, 1.0 + rng.rand(80)).astype(
        np.float32)
    return jspec, tspec, pos, inv_mass


@pytest.mark.parametrize("form", ["scatter", "gather", "offset"])
def test_spring_passes_match_jax(form):
    """Each spring pass on the same positions, masses and springs as the
    JAX pass: deltas to 1e-6, counts exact."""
    jspec, tspec, pos, inv_mass = _spring_inputs()
    jp, tp = jnp.asarray(pos), torch.as_tensor(pos)
    jw, tw = jnp.asarray(inv_mass), torch.as_tensor(inv_mass)
    if form == "scatter":
        j = jsol._spring_deltas(jp, jw, jspec.springs)
        t = tsol._spring_deltas(tp, tw, tspec.springs)
    elif form == "gather":
        j = jsol._spring_deltas_gather(
            jp, jw, jspec.springs,
            jstate.build_spring_incidence(jspec.springs, 80))
        t = tsol._spring_deltas_gather(
            tp, tw, tspec.springs,
            tstate.build_spring_incidence(tspec.springs, 80))
    else:
        jspec = jbuild.attach_incidence(jspec, 80)
        tspec = tbuild.attach_incidence(tspec, 80)
        j = jsol._spring_deltas_offset(jp, jw, jspec.offset_springs)
        t = tsol._spring_deltas_offset(tp, tw, tspec.offset_springs)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    assert float(t[0].abs().max()) > 0.01 and float(t[1].sum()) > 0


@pytest.fixture(scope="module")
def sheet():
    """The reduced sheet, JAX-built, 0.02 above the floor, jittered, with
    the box (the design point's pusher) at its edge moving 0.02 a frame."""
    shapes = jstate.make_shapes([jstate.SHAPE_PLANE, jstate.SHAPE_BOX],
                                [[0, 0, 0], list(dp.PUSHER_HALF)],
                                [[0, 0, 0], [0, 20.0, 0]],
                                [[0, 0, 0, 1], [0, 0, 0, 1]], m_max=2)
    jb = j_build_scene("cloth", np.random.RandomState(0), shapes=shapes,
                       caps=jbuild.Caps(*_SMALL),
                       scene_overrides={"dimx": 24, "dimz": 24,
                                        "origin": np.array([-0.5, 0.02, 0.0])})
    rng = np.random.RandomState(1)
    pos = np.asarray(jb.state.particles.pos).copy()
    pos[: jb.n_active, 0::2] += rng.uniform(-0.006, 0.006, (jb.n_active, 2))
    pts = pos[: jb.n_active]
    ptraj = np.tile(np.asarray(jb.state.shapes.pos)[None], (_T, 1, 1))
    ptraj[:, 1, 0] = pts[:, 0].min() - dp.PUSHER_HALF[0] - 0.01 + 0.02 * np.arange(_T)
    ptraj[:, 1, 1] = dp.CLOTH_PUSHER_Y
    ptraj[:, 1, 2] = pts[:, 2].mean()
    qtraj = np.tile(np.asarray(jb.state.shapes.quat)[None], (_T, 1, 1))
    st = jb.state._replace(
        particles=jb.state.particles._replace(pos=jnp.asarray(pos)),
        shapes=jb.state.shapes._replace(pos=jnp.asarray(ptraj[0]),
                                        prev_pos=jnp.asarray(ptraj[0])))
    return jb, st, ptraj.astype(np.float32), qtraj.astype(np.float32)


@pytest.mark.parametrize("mode", ["dense", "block"])
def test_cloth_frames_match_jax(sheet, mode):
    """3 frames of the reduced sheet on both sides, in the dense mode (the
    auto mode at this size) and in forced block mode (rest filter on):
    the offset-family spring pass, particle contacts and the box and floor
    contacts all act."""
    jb, st, ptraj, qtraj = sheet
    jf, jrec = j_rollout(st, jb.spec, jnp.asarray(ptraj), jnp.asarray(qtraj),
                         *_SCHEDULE, contact_mode=mode)
    ts, tspec = tstate.scene_from_numpy(tstate.tree_to_numpy(st),
                                        tstate.tree_to_numpy(jb.spec), "cpu")
    assert tspec.offset_springs.offsets == (1, 24, 23, 25, 2, 48)
    tf, trec = rollout_steps(ts, tspec, ptraj, qtraj, *_SCHEDULE,
                             contact_mode=mode)
    per_particle = np.abs(trec.numpy() - np.asarray(jrec)).max(axis=(0, 2))
    assert per_particle.max() <= _ATOL, per_particle.max()
    assert int(tf.contact_overflow) == int(jf.contact_overflow) == 0
    p, prm = tf.particles, tspec.params
    contacts = sum(int(tck.dense_contact_deltas(
        x, x, p.group, p.inv_mass, p.self_collide, p.active, tspec.rest_pos,
        prm.solid_rest_distance, prm.particle_friction,
        prm.collide_filter_dist)[1].sum()) for x in trec)
    assert contacts > 0  # the jitter and the push bring 2-ring pairs in
    moved = np.abs(trec.numpy()[-1] - np.asarray(st.particles.pos))
    assert moved.max() > 0.01  # the box pushed the sheet's edge


def test_cloth_design_point_launches(monkeypatch):
    """The design point's first frame on the CPU, its wrappers counted:
    block mode at tile_j 128 over 39 row tiles (maxb 39), the rest filter
    on, K1 200 times (4 substeps x 50 iterations), K2 once, no dense sweep
    and no fused shape stage."""
    b = dp.cloth_design_point("cpu")
    n = b.state.particles.pos.shape[0]
    assert (b.n_active, n) == (4900, 4900)
    assert b.spec.offset_springs.offsets == (1, 70, 69, 71, 2, 140)
    assert tsol.auto_contact_mode(n) == "block" and tsol.auto_tile_j(n) == 128
    sh = b.state.shapes
    idx, cnt, _, _ = tsol.frame_block_lists(
        b.state.particles, b.spec, (sh.pos - sh.prev_pos) / b.spec.params.dt,
        128)
    assert tuple(idx.shape) == (39, 39)
    assert float(sh.pos[1, 1]) == pytest.approx(dp.CLOTH_PUSHER_Y)
    assert float(b.state.particles.pos[:, 1].min()) == pytest.approx(
        dp.CLOTH_GAP)
    seen = {"k1": [], "k2": [], "k3": 0}
    k1, k2 = tsol.block_sparse_contact_deltas_packed, \
        tsol.refine_overlap_blocks_packed

    def c1(*a, **k):
        seen["k1"].append((k.get("rest_filter"), k.get("tile_j"),
                           "shp" in k))
        return k1(*a, **k)

    def c2(*a, **k):
        seen["k2"].append((k.get("rest_filter"), k.get("tile_j")))
        return k2(*a, **k)

    def c3(*a, **k):
        seen["k3"] += 1
        raise AssertionError("the dense sweep in block mode")

    monkeypatch.setattr(tsol, "block_sparse_contact_deltas_packed", c1)
    monkeypatch.setattr(tsol, "refine_overlap_blocks_packed", c2)
    monkeypatch.setattr(tsol, "dense_contact_deltas_packed", c3)
    pos, quat = dp.cloth_sweep(b, 1)
    fin, rec = rollout_steps(b.state, b.spec, pos, quat, b.substeps,
                             b.iterations)
    assert seen["k1"] == [(True, 128, False)] * 200
    assert seen["k2"] == [(True, 128)]
    assert bool(torch.isfinite(rec).all())
    assert float(rec[0, :, 1].max()) < dp.CLOTH_GAP  # falling
