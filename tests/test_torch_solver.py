"""Port parity: the XPBD rope frame (xpbd_step, rollout_steps) against the
JAX solver, plus the port's device rule and its import boundary.

The rope is the bench scene's rope (length 6, along z) at 512 particles,
lifted to the sampler's height so it falls, with the box pusher sweeping
into it: particle contacts, shape contacts and both cluster passes all act.
Both sides use the `block` contact mode; the JAX kernels run in interpret
mode. Positions agree within 1e-4 over 3 frames (float32 sums in another
order, amplified over 24 Jacobi iterations; the observed gap is ~1e-6).
Such a comparison needs a frame whose result is continuous in its input:
some pusher sweeps flip a contact decision under a 1e-7 perturbation of
the JAX solver's own input and move its output by ~2e-4, and no port could
match such a frame closer than that. This sweep is not one of them."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptigraph_tpu.engine import rollout_steps as j_rollout
from adaptigraph_tpu.engine import state as jstate
from adaptigraph_tpu.engine import xpbd_step as j_step
from adaptigraph_tpu.scenes import build_scene as j_build_scene
from adaptigraph_tpu.scenes.build import Caps as JCaps
from adaptigraph_torch import resolve_device
from adaptigraph_torch.engine import contact_kernels as tck
from adaptigraph_torch.engine.solver import rollout_steps, xpbd_step
from adaptigraph_torch.engine.state import scene_from_numpy, tree_to_numpy
from adaptigraph_torch.scenes import build_scene

_T = 3
_ATOL = 1e-4


@pytest.fixture(scope="module")
def rope():
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
    return scene_from_numpy(tree_to_numpy(state), tree_to_numpy(spec), "cpu")


def _contacts(state, spec):
    """Particle contacts at the frame's start positions, over the frame's
    AABB block lists (the K1 count the first iteration would see)."""
    p, prm = state.particles, spec.params
    rows, cols = tck.pack_contact_tables(p.pos, p.pos, p.group, p.inv_mass,
                                         p.self_collide, p.active, spec.rest_pos)
    idx, cnt, _ = tck.tile_overlap_blocks(p.pos, p.active, prm.radius * 1.5)
    _, c = tck.block_sparse_contact_deltas_packed(
        p.pos.shape[0], rows, cols, prm.solid_rest_distance,
        prm.particle_friction, prm.collide_filter_dist, idx, cnt)
    return int(c.sum())


def test_xpbd_step_matches_jax_frame_by_frame(rope):
    """Each frame from the same input state on both sides."""
    b, pos_traj, quat_traj = rope
    js, spec = b.state, b.spec
    contacts = 0
    for t in range(_T):
        js = js._replace(shapes=js.shapes.moved_to(jnp.asarray(pos_traj[t]),
                                                   jnp.asarray(quat_traj[t])))
        ts, tspec = _port(js, spec)
        js = j_step(js, spec, b.substeps, b.iterations, contact_mode="block")
        out = xpbd_step(ts, tspec, b.substeps, b.iterations,
                        contact_mode="block")
        np.testing.assert_allclose(out.particles.pos.numpy(),
                                   np.asarray(js.particles.pos), rtol=0,
                                   atol=_ATOL)
        np.testing.assert_allclose(out.particles.vel.numpy(),
                                   np.asarray(js.particles.vel), rtol=0,
                                   atol=_ATOL * 60 * b.substeps)
        np.testing.assert_allclose(out.cluster_rot.numpy(),
                                   np.asarray(js.cluster_rot), rtol=0,
                                   atol=_ATOL)
        assert int(out.contact_overflow) == int(js.contact_overflow) == 0
        contacts += _contacts(out, tspec)
    assert contacts > 0  # the sweep exercised the particle contact pass


def test_rollout_steps_matches_jax(rope):
    b, pos_traj, quat_traj = rope
    jf, jrec = j_rollout(b.state, b.spec, jnp.asarray(pos_traj),
                         jnp.asarray(quat_traj), substeps=b.substeps,
                         iterations=b.iterations, contact_mode="block")
    ts, tspec = _port(b.state, b.spec)
    tf, trec = rollout_steps(ts, tspec, pos_traj, quat_traj, b.substeps,
                             b.iterations, contact_mode="block")
    assert trec.shape == (_T,) + tuple(ts.particles.pos.shape)
    np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), rtol=0,
                               atol=_ATOL)
    moved = np.abs(np.asarray(jrec[-1]) - np.asarray(b.state.particles.pos))
    assert moved.max() > 0.01  # the pusher moved the rope
    assert int(tf.contact_overflow) == int(jf.contact_overflow)
    _, none = rollout_steps(ts, tspec, pos_traj[:1], quat_traj[:1],
                            b.substeps, b.iterations, record=False,
                            contact_mode="block")
    assert none is None


@pytest.mark.parametrize("stiffness", [0.0, 3e-4])
def test_global_cluster_pass_matches_jax(stiffness):
    """The global shape-matching pass, which the rope's build folds into
    the cluster matmul, for a scene where it is not folded. Tolerance:
    float32 sums over 300 particles and six polar iterations (1e-5)."""
    from adaptigraph_tpu.engine import solver as jsol
    from adaptigraph_torch.engine import solver as tsol

    rng = np.random.RandomState(4)
    n = 300
    rest = rng.randn(n, 3).astype(np.float32) * 0.3
    c, s_ = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
    # a rotated, deformed and shifted copy of the rest shape
    pos = (rest @ rot.T + rng.randn(n, 3).astype(np.float32) * 0.02
           + 0.5).astype(np.float32)
    active = rng.rand(n) > 0.1
    inv_mass = np.where(rng.rand(n) > 0.2, 1.0, 0.0).astype(np.float32)
    q_prev = np.array([0.1, 0.0, 0.0, 1.0], np.float32)
    q_prev /= np.linalg.norm(q_prev)
    j = jsol._global_cluster_deltas(
        jnp.asarray(pos), jnp.asarray(active), jnp.asarray(inv_mass),
        jnp.asarray(rest), jnp.float32(stiffness), jnp.asarray(q_prev))
    t = tsol._global_cluster_deltas(
        torch.as_tensor(pos), torch.as_tensor(active),
        torch.as_tensor(inv_mass), torch.as_tensor(rest),
        torch.tensor(stiffness, dtype=torch.float32), torch.as_tensor(q_prev))
    for a, b in zip(j, t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-5)


def test_unported_contact_modes_raise(rope, monkeypatch):
    """The sparse mode still raises. The dense mode is ported: at 512
    particles the auto mode picks it, sweeps with K3 on every solver
    iteration and reaches neither block kernel."""
    from adaptigraph_torch.engine import solver as tsol

    b, pos_traj, quat_traj = rope
    ts, tspec = _port(b.state, b.spec)
    assert tsol.auto_contact_mode(512) == "dense"
    calls = []
    k3 = tsol.dense_contact_deltas_packed

    def counted(*a, **k):
        calls.append(1)
        return k3(*a, **k)

    def refused(*a, **k):
        raise AssertionError("a block kernel was reached in dense mode")

    monkeypatch.setattr(tsol, "dense_contact_deltas_packed", counted)
    monkeypatch.setattr(tsol, "block_sparse_contact_deltas_packed", refused)
    monkeypatch.setattr(tsol, "refine_overlap_blocks_packed", refused)
    out = xpbd_step(ts, tspec, 2, 4)
    assert len(calls) == 2 * 4
    assert bool(torch.isfinite(out.particles.pos).all())
    with pytest.raises(NotImplementedError, match="item 15"):
        rollout_steps(ts, tspec, pos_traj, quat_traj, 2, 4,
                      contact_mode="sparse")


def test_entry_points_without_a_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_scene("rope", np.random.RandomState(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scene_from_numpy({}, {})
    assert resolve_device("cpu") == torch.device("cpu")


_ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "adaptigraph_tpu", "yaml", "h5py")


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(_ROOT)) for p in
                   list((_ROOT / "adaptigraph_torch").rglob("*.py"))
                   + [_ROOT / "chip_smoke.py"]))
def test_port_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports JAX, the JAX
    package, PyYAML or h5py, at any depth of the file."""
    tree = ast.parse((_ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__",) or isinstance(node, ast.Call) and getattr(
                  node.func, "attr", None) == "import_module"):
            names = [a.value for a in node.args if isinstance(a, ast.Constant)]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, (path, name)
