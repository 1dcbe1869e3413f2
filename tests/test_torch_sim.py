"""Port parity: the simulator app (sim/cameras.py, sim/robot.py,
sim/env.py's SimEnv) against the JAX package on the CPU.

Most cases run both packages' SimEnv on a tiny scene: tests/test_sim.py's
36-particle block at cap 64, here held together by one shape-matching
cluster (each package's build_scene is monkeypatched with its own
equivalent, _jax_build and _port_build). tests/test_sim.py's loose pile
is chaotic under a push: a 1e-6 nudge of its input moves JAX's own pushed
positions by up to 2.7e-3, so no port could be held to it; the clustered
block moves by rounding only. Tolerances, with the maxima measured:
- cameras and the arm's text copy bit for bit;
- FK positions and rotations, link_pose_traj's positions and
  pusher_orientation within 1e-6 (2.4e-7, 1.2e-7, 4.8e-7, 0); the link
  quaternions as rotation matrices within 1e-6 (a quaternion component
  near zero is the square root of a difference of ones, so 1e-7 in the
  matrix moves it by ~1e-5; at a 180-degree link rotation JAX's
  branchless matrix_to_quat takes a component's sign from a difference
  that is zero but for rounding);
- ik_solve (60 iterations) and ik_traj over 120 frames within 2e-5
  (7.3e-6: float32 rounding over warm-started DLS updates; the port
  writes the Jacobian out where JAX takes jax.jacfwd);
- plan_push's eef track and schedules within 1e-5 (1.1e-6), its link
  positions within 5e-5 (2.0e-5), its final joints after 160 frames
  within 5e-5 (2.2e-5), and its tool frames (from the last link's
  quaternion) within 5e-4 (1.9e-5; see _link_quats_close);
- a push (plan, IK, frames, captures) within 1e-4 (5e-6) and its
  captured images equal but for values off by one;
- the real rope (2,898 particles in a 3,072 cap, the arm's 11 shape
  slots, block mode) through its 40-frame settle within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptigraph_tpu.sim.env as jenv
import adaptigraph_torch.sim.env as tenv
from adaptigraph_tpu.engine import state as jstate
from adaptigraph_tpu.scenes.build import Caps as JCaps
from adaptigraph_tpu.scenes.build import SceneBuild as JBuild
from adaptigraph_tpu.sim import cameras as jcam
from adaptigraph_tpu.sim import robot as jrobot
from adaptigraph_tpu.utils import Config
from adaptigraph_tpu.utils import geometry as jgeo
from adaptigraph_torch.engine import state as tstate
from adaptigraph_torch.engine.solver import _shape_table
from adaptigraph_torch.scenes.build import Caps as TCaps
from adaptigraph_torch.scenes.build import SceneBuild as TBuild
from adaptigraph_torch.sim import cameras as tcam
from adaptigraph_torch.sim import robot as trobot
from adaptigraph_torch.utils import geometry as tgeo

_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
# the real scene builders and caps (the tiny cases patch them module-wide)
_REAL = ((jenv, jenv.build_scene, dict(jenv.MATERIAL_CAPS)),
         (tenv, tenv.build_scene, dict(tenv.MATERIAL_CAPS)))
BASE = np.array([-4.1, 0.8, 0.0], np.float32)
PUSH = np.array([-1.5, 0.1, 0.8, 0.1])
_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------- the tiny scene, in each package ----------

def _block(spacing=0.08):
    g = np.stack(np.meshgrid(np.arange(4), np.arange(3), np.arange(3),
                             indexing="ij"), -1).reshape(-1, 3)
    return (g * spacing + np.array([-0.15, 0.55, -0.1])).astype(np.float32)


def _jax_build(material, rng, shapes=None, caps=None):
    pts = _block()
    particles = jstate.make_particles(pts, group=0, self_collide=True, n_max=64)
    spec = jstate.SceneSpec(
        springs=jstate.empty_springs(4),
        clusters=jstate.make_clusters([np.arange(36)], pts, 1.0, c_max=2,
                                      k_max=64),
        global_stiffness=jnp.float32(0.0), global_rest=jnp.zeros((0, 3)),
        rest_pos=jnp.asarray(np.pad(pts, ((0, 28), (0, 0)))),
        params=jstate.SolverParams(collision_distance=jnp.float32(0.03)))
    state = jstate.SceneState(
        particles=particles, shapes=shapes,
        cluster_rot=jnp.tile(jnp.array([0.0, 0, 0, 1.0]), (2, 1)),
        global_rot=jnp.array([0.0, 0, 0, 1.0]))
    return JBuild(state=state, spec=spec, scene={}, props={"stiffness": 0.5},
                  n_active=36, substeps=2, iterations=2)


def _port_build(material, rng, shapes=None, caps=None, device=None,
                spacing=0.08):
    pts = _block(spacing)
    particles = tstate.make_particles(pts, group=0, self_collide=True,
                                      n_max=64, device=device)
    spec = tstate.SceneSpec(
        springs=tstate.empty_springs(4, device=device),
        clusters=tstate.make_clusters([np.arange(36)], pts, 1.0, c_max=2,
                                      k_max=64, device=device),
        global_stiffness=torch.tensor(0.0, device=device),
        global_rest=torch.zeros((0, 3), device=device),
        rest_pos=torch.as_tensor(np.pad(pts, ((0, 28), (0, 0))), device=device),
        params=tstate.make_params(device, collision_distance=0.03))
    state = tstate.SceneState(
        particles=particles, shapes=shapes,
        cluster_rot=torch.tensor([[0.0, 0, 0, 1.0]], device=device).repeat(2, 1),
        global_rot=torch.tensor([0.0, 0, 0, 1.0], device=device),
        contact_overflow=torch.zeros((), dtype=torch.int32, device=device))
    return TBuild(state=state, spec=spec, scene={}, props={"stiffness": 0.5},
                  n_active=36, substeps=2, iterations=2)


TINY = {"obj": "rope", "pusher_len": 1.0, "robot_speed_inv": 10,
        "screenWidth": 48, "screenHeight": 48, "max_chunks": 3,
        "settle_steps": 10, "action_space": 2, "camera_view": 1, "fps": False}
GRIPPER = dict(TINY, obj="cloth", gripper=True, max_chunks=4)


def patch_tiny(monkeypatch, spacing=0.08):
    """Both packages' SimEnv build the tiny block at cap 64 (the port's at
    another lattice spacing when asked)."""
    monkeypatch.setattr(jenv, "build_scene", _jax_build)
    monkeypatch.setattr(tenv, "build_scene", functools.partial(
        _port_build, spacing=spacing))
    for obj in ("rope", "cloth"):
        monkeypatch.setitem(jenv.MATERIAL_CAPS, obj,
                            JCaps(n=64, s=4, c=2, k=64, m=8))
        monkeypatch.setitem(tenv.MATERIAL_CAPS, obj,
                            TCaps(n=64, s=4, c=2, k=64, m=8))


def tiny_envs(monkeypatch, **over):
    """(JAX SimEnv, port SimEnv on the CPU) on the tiny block."""
    patch_tiny(monkeypatch)
    cfg = {"dataset": dict(TINY, **over)}
    return jenv.SimEnv(Config(cfg)), tenv.SimEnv(cfg, device="cpu")


@pytest.fixture(scope="module")
def stick():
    """The stick envs, shared by the file's cases (each JAX SimEnv
    compiles its own push programs): every case resets them."""
    with pytest.MonkeyPatch.context() as mp:
        yield tiny_envs(mp)


@pytest.fixture(scope="module")
def gripper():
    with pytest.MonkeyPatch.context() as mp:
        yield tiny_envs(mp, **GRIPPER)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(port, ref, atol):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=atol)


def _images_close(port_imgs, jax_imgs):
    """Quantised captures equal but for values off by one."""
    for (ct, dt), (cj, dj) in zip(port_imgs, jax_imgs):
        for a, b in ((ct, cj), (dt, dj)):
            assert a.dtype == b.dtype and a.shape == b.shape
            gap = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert gap.max() <= 1 and (gap > 0).mean() <= 5e-3


# ---------- cameras and the arm ----------

def test_cameras_bit_for_bit():
    for w, h in ((720, 720), (360, 240)):
        rj, rt = jcam.CameraRig(w, h), tcam.CameraRig(w, h)
        for a, b in zip(rt.multiview(), rj.multiview()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(rt.intrinsics(), rj.intrinsics())
        for view in range(5):
            for a, b in zip(rt.single_view(view), rj.single_view(view)):
                assert np.array_equal(a, b)
    pos, ang = np.array([6.0, 10, 6]), np.array([0.8, -0.7, 0.0])
    assert np.array_equal(tcam.view_matrix(pos, ang), jcam.view_matrix(pos, ang))


def test_arm_text_equals_npz_bit_for_bit():
    raw = np.load(_ROOT / "data" / "assets" / "xarm6_links.npz")
    text = trobot.read_arm_text()
    assert sorted(text) == sorted(raw.files)
    assert list(text["links"]) == [str(x) for x in raw["links"]]
    values = 0
    for key in raw.files:
        if key == "links":
            continue
        assert text[key].dtype == raw[key].dtype == np.float32
        assert np.array_equal(text[key].view(np.uint32),
                              raw[key].view(np.uint32)), key
        values += raw[key].size
    assert values == 14560
    a, b = trobot.load_arm_assets(10.0), jrobot.load_arm_assets(10.0)
    assert a["links"] == b["links"]
    for key in ("planes", "surf", "surf_n"):
        for x, y in zip(a[key], b[key]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_fk_link_poses_and_pusher_orientation():
    q = np.random.RandomState(0).uniform(-0.5, 0.5, (4, 6)).astype(np.float32)
    for i in range(4):
        pj, rj = jrobot.fk_link_poses(jnp.asarray(q[i]), jnp.asarray(BASE))
        pt, rt = trobot.fk_link_poses(torch.as_tensor(q[i]), BASE)
        _close(pt, pj, 1e-6)
        _close(rt, rj, 1e-6)
    lpj, lqj = jrobot.link_pose_traj(jnp.asarray(q), jnp.asarray(BASE))
    lpt, lqt = trobot.link_pose_traj(torch.as_tensor(q), BASE)
    assert lpt.shape == (4, 7, 3) and lqt.shape == (4, 7, 4)
    _close(lpt, lpj, 1e-6)
    _close(tgeo.quat_to_matrix(lqt), jax.vmap(jgeo.quat_to_matrix)(lqj), 2e-5)
    angles = np.array([0.0, 0.3, 0.7, -1.2, np.pi / 2], np.float32)
    for a in angles:
        _close(trobot.pusher_orientation(a),
               jrobot.pusher_orientation(jnp.float32(a)), 1e-6)
    _close(trobot.pusher_orientation(angles),
           jrobot.pusher_orientation(jnp.asarray(angles)), 1e-6)


def test_ik_solve_and_ik_traj():
    target = np.array([-1.0, 2.0, 0.5], np.float32)
    rot = np.asarray(jrobot.pusher_orientation(jnp.float32(0.3)))
    qj = jrobot.ik_solve(jnp.asarray(target), jnp.asarray(rot), jnp.zeros(6),
                         jnp.asarray(BASE), iters=60)
    qt = trobot.ik_solve(target, rot, np.zeros(6, np.float32), BASE, iters=60)
    _close(qt, qj, 2e-5)
    p, _ = trobot.fk_eef(qt, BASE)
    assert float(np.linalg.norm(_np(p) - target)) < 0.15
    t = 120
    targets = np.stack([np.linspace(-1.5, 0.5, t), np.full(t, 1.5),
                        np.linspace(0.5, -0.5, t)], 1).astype(np.float32)
    rots = np.tile(rot[None], (t, 1, 1))
    qj = jrobot.ik_traj(jnp.asarray(targets), jnp.asarray(rots), jnp.zeros(6),
                        jnp.asarray(BASE))
    qt = trobot.ik_traj(targets, rots, np.zeros(6, np.float32), BASE)
    assert qt.shape == (t, 6)
    _close(qt, qj, 2e-5)


# ---------- SimEnv on the tiny block ----------

def _link_quats_close(qt, qj):
    """Link quaternions: every component's magnitude within 2e-4, and the
    rotations within 5e-4 but where JAX's w is within 1e-3 of zero. A
    component near zero is the square root of a sum near zero, so one ulp
    of 1 in that sum (1.2e-7) moves it by up to 1.7e-4 in either package,
    and a rotation entry 2 (x y - z w) by twice that; where w is near zero, matrix_to_quat takes each component's sign from a
    difference that is zero but for rounding (kept for parity), so only
    the magnitudes can be held. Returns that frame count."""
    qt, qj = np.asarray(qt), np.asarray(qj)
    _close(np.abs(qt), np.abs(qj), 2e-4)
    flip = np.abs(qj[..., 3]) < 1e-3
    _close(tgeo.quat_to_matrix(torch.as_tensor(qt[~flip])),
           jax.vmap(jgeo.quat_to_matrix)(jnp.asarray(qj[~flip])), 5e-4)
    return int(flip.sum())


@pytest.mark.parametrize("kind", ["stick", "gripper"])
def test_plan_push_matches_jax(kind, request):
    je, te = request.getfixturevalue(kind)
    je.reset(seed=2)
    te.reset(seed=2)
    action = np.array([0.0, 0.0, 0.8, 0.3]) if kind == "gripper" else PUSH
    pj, pt = je.plan_push(action), te.plan_push(action)
    assert pt["t_push"] == pj["t_push"]
    for key in ("eef", "gap", "attach_active"):
        assert pt[key].shape == pj[key].shape, key
        _close(pt[key], pj[key], 1e-5)
    # the link poses follow the joints (2e-5) through lever arms of ~1; the
    # tool frames come from the last link's quaternion
    _close(pt["link_pos"], pj["link_pos"], 5e-5)
    _close(pt["rot"], pj["rot"], 5e-4)
    _link_quats_close(pt["link_quat"], pj["link_quat"])
    # the grasp's k nearest particles: the same set with the same offsets
    # (two of the block's lattice points tie in distance, and rounding
    # orders them)
    ot, oj = np.argsort(pt["attach_idx"]), np.argsort(pj["attach_idx"])
    np.testing.assert_array_equal(pt["attach_idx"][ot], pj["attach_idx"][oj])
    _close(pt["attach_rel"][ot], pj["attach_rel"][oj], 1e-4)
    _close(pt["q_final"], pj["q_final"], 5e-5)
    if kind == "gripper":
        assert pt["attach_active"].any()


def test_reset_capture_schema_and_selection(stick):
    je, te = stick
    dj = je.reset(seed=0, save_data=True)
    dt = te.reset(seed=0, save_data=True)
    (imgs, parts, eefs) = dt
    assert len(imgs) == len(parts) == len(eefs) == 1
    color, depth = imgs[0]
    assert color.shape == (4, 48, 48, 3) and color.dtype == np.uint8
    assert depth.shape == (4, 48, 48) and depth.dtype == np.uint16
    assert parts[0].shape == (36, 3) and eefs[0].shape == (1, 14)
    _close(parts[0], dj[1][0], 1e-6)
    _close(eefs[0], dj[2][0], 1e-6)
    _images_close(imgs, dj[0])
    np.testing.assert_array_equal(te.cam_extrinsic_matrix,
                                  je.cam_extrinsic_matrix)
    # the contact-gated cadence picks the same chunk ends from the same
    # records: chunk 0 out of contact (step 40, skipped at the 80-step
    # interval), chunk 1 in contact, and the settle's last
    rec = np.tile(parts[0][None], (3, 1, 1))
    eef = np.stack([parts[0][0] + [3.0, 0, 0], parts[0][0] + [0.05, 0.5, 0.0],
                    parts[0][0]]).astype(np.float32)
    sel = te._select_captures(rec, eef, t_push=80)
    captured = []
    je._render_capture_batch = lambda pos_rec, selected: (
        captured.append(list(selected)) or [(color, depth)] * len(selected))
    try:
        je._capture_push(([], [], []), rec, eef, np.tile(np.eye(3), (3, 1, 1)),
                         80)
    finally:
        del je._render_capture_batch
    assert sel == captured[0] == [1, 2]


def test_push_matches_jax(stick):
    """A stick push through the block: plan, IK, frames and captures."""
    je, te = stick
    je.reset(seed=0)
    te.reset(seed=0)
    before = te.get_positions()
    oj = je.step(PUSH, save_data=True, data=([], [], []))
    ot = te.step(PUSH, save_data=True, data=([], [], []))
    assert ot is not None and oj is not None
    obs, data = ot
    assert obs.shape == (48, 48, 5)
    after = te.get_positions()
    assert np.linalg.norm(after - before, axis=1).max() > 0.05
    _close(after, np.asarray(je.state.particles.pos)[:36], _ATOL)
    _close(te.state.shapes.pos, je.state.shapes.pos, 1e-5)
    assert len(data[1]) == len(oj[1][1]) >= 1
    for a, b in zip(data[1], oj[1][1]):
        _close(a, b, _ATOL)
    for a, b in zip(data[2], oj[1][2]):
        _close(a, b, 1e-5)
    _images_close(data[0], oj[1][0])
    np.testing.assert_allclose(obs, oj[0], rtol=0, atol=1e-3)
    _close(te._q_cur, je._q_cur, 2e-5)


def test_attach_free_loop_matches_attach_loop(stick):
    """The attach path's per-frame mutations are identities when no
    attachment is active: forcing it on a rope push must give the
    attach-free path's records exactly (tests/test_sim.py's check)."""
    _, te = stick
    te.reset(seed=0)
    st0 = te.state
    plan = te.plan_push(PUSH)
    assert not plan["attach_active"].any()
    n_chunks = min(-(-(plan["t_push"] + te.settle_steps) // 40), te.max_chunks)
    out = {}
    for forced in (False, True):
        st, rec, _, _, bad = te._push_fn(
            st0, te.spec, plan["eef"], plan["rot"], plan["gap"],
            plan["attach_idx"], plan["attach_rel"], plan["attach_active"],
            n_chunks_active=n_chunks, link_pos_traj=plan["link_pos"],
            link_quat_traj=plan["link_quat"], attach_path=forced)
        assert not bad[0]
        out[forced] = (st.particles.pos.numpy(), rec)
    np.testing.assert_array_equal(out[False][0], out[True][0])
    np.testing.assert_array_equal(out[False][1], out[True][1])


def test_gripper_grasp_cycle(gripper):
    """A grasp pins the nearest particles to the fingers for the push and
    release restores their inverse mass; the grasped block moves as
    JAX's does."""
    je, te = gripper
    je.reset(seed=2)
    te.reset(seed=2)
    w0 = te.state.particles.inv_mass.numpy().copy()
    action = np.array([0.0, 0.0, 0.8, 0.3])
    oj = je.step(action, save_data=True, data=([], [], []))
    ot = te.step(action, save_data=True, data=([], [], []))
    assert ot is not None and oj is not None
    np.testing.assert_array_equal(te.state.particles.inv_mass.numpy(), w0)
    assert ot[1][2][0].shape == (2, 14)
    _close(te.get_positions(), np.asarray(je.state.particles.pos)[:36], _ATOL)
    for a, b in zip(ot[1][1], oj[1][1]):
        _close(a, b, _ATOL)


def test_seed_determinism(stick):
    _, te = stick
    runs = []
    for _ in range(2):
        data = te.reset(seed=3, save_data=True)
        action = te.sample_action()
        obs, data = te.step(action, save_data=True, data=data)
        runs.append((action, te.get_positions(), data, obs))
    (a0, p0, d0, o0), (a1, p1, d1, o1) = runs
    np.testing.assert_array_equal(a0, a1)
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(o0, o1)
    for x, y in zip(d0[0], d1[0]):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))


def test_fused_shapes_skip_arm_links_4_to_6(monkeypatch):
    """Kept for parity: with fuse_shapes the fused stage takes the first
    caps.m = 8 slots, but the arm's shape set has 11 (floor, two tables,
    the stick, 7 links), so links 4-6 (slots 8-10; link 6 carries the
    tool) are never collided with, in both packages."""
    je, te = tiny_envs(monkeypatch, fuse_shapes=1)
    je.reset(seed=0, settle=False)
    te.reset(seed=0, settle=False)
    assert je.n_shapes_fused == te.n_shapes_fused == 8
    assert je.state.shapes.kind.shape[0] == te.state.shapes.kind.shape[0] == 11
    sh = te.state.shapes
    shp, planes2d = _shape_table(sh, sh.pos, sh.quat, torch.zeros_like(sh.pos),
                                 te.n_shapes_fused)
    assert shp.shape[0] == 8 and planes2d.shape[0] == 8 * sh.planes.shape[1]
    kinds = sh.kind.tolist()
    assert kinds[8:] == [tstate.SHAPE_CONVEX] * 3 and sh.valid[8:].all()
    _, off = tiny_envs(monkeypatch)
    assert off.n_shapes_fused is None


def test_simenv_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenv.SimEnv({"dataset": dict(TINY)})


def test_real_rope_frames_match_jax(monkeypatch):
    """The rope data-gen scene at its cap (2,898 of 3,072 particles, block
    mode: K2 and K1's plain versions here) with the arm's 11 shape slots:
    the built scene, then the settle's first frames through each
    package's push loop (chunks cut to 3 frames, one group: the
    attach-free path packs its tables once), then the capture of that
    state at 48 x 48."""
    for mod, build, caps in _REAL:
        monkeypatch.setattr(mod, "build_scene", build)
        monkeypatch.setitem(mod.MATERIAL_CAPS, "rope", caps["rope"])
        monkeypatch.setattr(mod, "CHUNK", 3)
    cfg = {"dataset": {"obj": "rope", "max_chunks": 1, "settle_steps": 3,
                       "screenHeight": 48, "screenWidth": 48}}
    je = jenv.SimEnv(Config(cfg))
    te = tenv.SimEnv(cfg, device="cpu")
    je.reset(seed=0, settle=False)
    te.reset(seed=0, settle=False)
    assert te.n_active == je.n_active == 2898
    assert te.state.shapes.kind.shape[0] == 11 and te.n_arm == 7
    _close(te.state.particles.pos, je.state.particles.pos, 0.0)
    _close(te.state.shapes.pos, je.state.shapes.pos, 1e-6)
    park = (np.tile([[0.0, 20.0, 0.0]], (3, 1)).astype(np.float32),
            np.tile(np.eye(3, dtype=np.float32)[None], (3, 1, 1)),
            np.full(3, 0.4, np.float32), np.zeros(10, np.int64),
            np.zeros((10, 3), np.float32), np.zeros(3, np.float32))
    stj, recj, _, _, badj = je._push_fn(je.state, je.spec, *park,
                                        n_chunks_active=1,
                                        max_chunks_override=1)
    stt, rect, _, _, badt = te._push_fn(te.state, te.spec, *park,
                                        n_chunks_active=1,
                                        max_chunks_override=1)
    assert not badj[0] and not badt[0]
    _close(rect, recj, _ATOL)
    _close(stt.particles.pos, stj.particles.pos, _ATOL)
    _close(stt.particles.vel, stj.particles.vel, _ATOL * 60)
    assert np.abs(rect[0] - te.build.state.particles.pos.numpy()).max() > 1e-4
    assert int(stt.contact_overflow) == int(stj.contact_overflow) == 0
    je.state, te.state = stj, stt
    dj = je.finish_reset(save_data=True)
    dt = te.finish_reset(save_data=True)
    _close(dt[1][0], dj[1][0], _ATOL)
    _images_close(dt[0], dj[0])


def test_ik_track_beyond_reach_depends_on_rounding_in_jax():
    """Kept for parity: the rope data-gen config's episode 0 samples a push
    that starts 7.5 from the arm's base, out of its reach. There JAX's own
    IK track jumps to another branch (the stick rising to y 3.8, never
    meeting the rope) under a 1e-7 nudge of its start joints, so the port
    cannot be held to it; on a push within reach the track is continuous
    and the port follows JAX's within 2e-5 over the whole trajectory."""
    env = tenv.SimEnv({"dataset": {"obj": "rope", "max_chunks": 8,
                                   "settle_steps": 40,
                                   "robot_speed_inv": 60}}, device="cpu")
    base = env.robot_base
    far = np.array([3.35966743, -0.72870874, -0.97036076, -0.73843896])
    near = np.array([-1.2, -2.16, 1.03, -1.14])
    for action, continuous in ((far, False), (near, True)):
        eef, rot, _, _, _ = env.scripted_track(action)
        rots = np.tile(rot[None], (eef.shape[0], 1, 1))
        qj = np.asarray(jrobot.ik_traj(jnp.asarray(eef), jnp.asarray(rots),
                                       jnp.zeros(6), jnp.asarray(base)))
        qn = np.asarray(jrobot.ik_traj(jnp.asarray(eef), jnp.asarray(rots),
                                       jnp.full(6, 1e-7, jnp.float32),
                                       jnp.asarray(base)))
        jump = np.abs(qn - qj).max()
        if continuous:
            assert jump < 1e-4
            _close(trobot.ik_traj(eef, rots, np.zeros(6, np.float32), base),
                   qj, 2e-5)
        else:
            assert jump > 1.0
