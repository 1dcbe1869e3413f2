"""Port parity: batched episode generation (sim/batch_env.py) and
engine/state.pad_cluster_matmul against the JAX package on the CPU. The
batch's port-only cases (a re-padded env 0, the CLI, the smoke's batch
phase) are tests/test_torch_batch_loop.py.

Both packages' BatchSimEnv run tests/test_torch_sim.py's tiny clustered
block (at tests/test_batch_env.py's config, 32 x 32 frames and a
10-frame settle, with 2 chunks of its 3) with two envs. JAX vmaps them
through one program; the port loops over its SimEnvs. Tolerances, as for the lone SimEnv
(tests/test_torch_sim.py): the settled and pushed positions within 1e-4,
plans within 1e-5 (the eef track) and 5e-5 (link positions), renders of
the same state within 1e-5 off the depth silhouettes, captures equal but
for values off by one.

Env 0 of the port's batch against a lone port SimEnv: bit for bit where
no spec was re-padded (the tiny block has no cluster matrix, so none
is).
"""

import os

import numpy as np
import pytest
import torch

import adaptigraph_tpu.sim.batch_env as jbatch
import adaptigraph_torch.sim.batch_env as tbatch
import adaptigraph_torch.sim.env as tenv
from adaptigraph_tpu.engine import state as jstate
from adaptigraph_tpu.sim import episode_io as jio
from adaptigraph_tpu.utils import Config
from adaptigraph_torch.engine import state as tstate
from adaptigraph_torch.sim import episode_io as tio
from adaptigraph_torch.sim import render as trender
from tests.test_torch_sim import (
    _REAL, GRIPPER, PUSH, TINY, _close, _images_close, patch_tiny)

BATCH = dict(TINY, screenWidth=32, screenHeight=32, max_chunks=2)
SEEDS = (7, 8)
_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(over):
    with pytest.MonkeyPatch.context() as mp:
        patch_tiny(mp)
        cfg = {"dataset": dict(BATCH, **over)}
        jb = jbatch.BatchSimEnv(Config(cfg), batch=2)
        tb = tbatch.BatchSimEnv(cfg, batch=2, device="cpu")
        yield jb, tb, cfg, mp


@pytest.fixture(scope="module")
def stick():
    """Both packages' batches of the stick, shared by the file's cases: a
    JAX BatchSimEnv compiles its vmapped programs once."""
    yield from _batches({})


@pytest.fixture(scope="module")
def gripper():
    yield from _batches(dict(GRIPPER, max_chunks=2, screenWidth=32,
                             screenHeight=32))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------- pad_cluster_matmul ----------

def test_pad_cluster_matmul_matches_jax(monkeypatch):
    """The rope data-gen scene's trimmed cluster matrix re-padded by 8 rows
    in both packages: equal bit for bit, the new rows inert."""
    (jmod, jbuild, _), (tmod, tbuild, _) = _REAL
    js = jbuild("rope", np.random.RandomState(0)).spec
    ts = tbuild("rope", np.random.RandomState(0), device="cpu").spec
    jm, tm = js.cluster_mm, ts.cluster_mm
    c = tm.matrix.shape[0]
    assert jm.matrix.shape[0] == c and c < ts.clusters.valid.shape[0]
    jp, tp = jstate.pad_cluster_matmul(jm, c + 8), tstate.pad_cluster_matmul(
        tm, c + 8)
    for a, b in zip(tp, jp):
        b = np.asarray(b)
        assert a.shape == b.shape and _np(a).dtype == b.dtype
        np.testing.assert_array_equal(_np(a), b)
    assert not tp.matrix[c:].any() and (tp.count[c:] == 1).all()
    assert tstate.pad_cluster_matmul(tm, c) is tm


# ---------- the batch against JAX's ----------

def _held(env, shape_pos):
    """Every shape slot's positions but the tool's. A parked tool follows
    the IK of the parked no-op's push (3.9, 3.9), out of the arm's reach,
    where the IK track depends on rounding in JAX itself (ROADMAP Queue
    3); lifted 19 above it, it meets nothing."""
    keep = [k for k in range(shape_pos.shape[0])
            if not env.tool_slot0 <= k < env.tool_slot0 + env.n_tool]
    return _np(shape_pos)[keep]


@pytest.fixture(scope="module")
def pushed(stick):
    """Both batches reset to SEEDS, then env 0 pushed by PUSH and env 1
    parked: the states after the reset, the first sampled actions (the
    rngs restored), and run_pushes' results."""
    jb, tb, _, _ = stick
    jb.reset(list(SEEDS))
    tb.reset(list(SEEDS))
    out = {"reset": ([e.state for e in tb.envs], jb.states), "actions": []}
    for e in tb.envs + jb.envs:
        st = e.rng.get_state()
        out["actions"].append(e.sample_action())
        e.rng.set_state(st)
    out["before"] = tb.envs[0].get_positions()
    out["jax"] = jb.run_pushes([PUSH, None])
    out["port"] = tb.run_pushes([PUSH, None])
    return out


def test_reset_states_match_jax(stick, pushed):
    _, tb, _, _ = stick
    tstates, jstates = pushed["reset"]
    for i, (env, st) in enumerate(zip(tb.envs, tstates)):
        _close(st.particles.pos, jstates.particles.pos[i], _ATOL)
        _close(st.particles.vel, jstates.particles.vel[i], 1e-2)
        _close(_held(env, st.shapes.pos), _held(env, jstates.shapes.pos[i]),
               1e-5)
        assert (st.shapes.pos[env.tool_slot0:, 1][:env.n_tool] > 15.0).all()
    # each env keeps its own rng stream
    a, b = pushed["actions"][:2], pushed["actions"][2:]
    assert not np.allclose(a[0], a[1])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[:2], y[:2])
        _close(x, y, 1e-5)


def test_run_pushes_one_pushed_one_parked_matches_jax(stick, pushed):
    jb, tb, _, _ = stick
    jr, jplans, jnan = pushed["jax"]
    tr, tplans, tnan = pushed["port"]
    # the push and its settle fit one chunk: captures pad it to max_chunks
    assert tr.shape == jr.shape == (2, 1, 64, 3)
    _close(tr, jr, _ATOL)
    np.testing.assert_array_equal(tnan, jnan)
    assert not tnan.any()
    for tp, jp in zip(tplans, jplans):
        assert tp["t_push"] == jp["t_push"]
        for key in ("gap", "attach_active"):
            _close(tp[key], jp[key], 1e-5)
        _close(tp["link_pos"], jp["link_pos"], 5e-5)
    # the pushed env's eef track; the parked one's follows an IK track
    # beyond the arm's reach (_held)
    _close(tplans[0]["eef"], jplans[0]["eef"], 1e-5)
    assert tplans[0]["t_push"] > 0 and tplans[1]["t_push"] == 0
    # the parked env's tool lifted 19 above its plan (which follows the
    # flailing IK track), its links at rest
    assert tplans[1]["eef"][:, 1].min() > 15.0
    np.testing.assert_array_equal(
        tplans[1]["link_pos"],
        np.tile(tb.envs[1]._rest_link_pos[None], (len(tplans[1]["eef"]), 1, 1)))
    assert np.abs(tb.envs[0].get_positions() - pushed["before"]).max() > 0.01
    for i in range(2):
        _close(tb.envs[i].state.particles.pos, jb.states.particles.pos[i],
               _ATOL)
        _close(tb.envs[i]._q_cur, jb.envs[i]._q_cur, 5e-5)
        _close(tb.envs[i]._gap_rec, jb.envs[i]._gap_rec, 0.0)
    # the parked env's planned joints are thrown away
    assert np.array_equal(tb.envs[1]._q_cur, np.zeros(6, np.float32))


def test_capture_matches_jax(stick, pushed):
    """The pushed env's and the parked env's captures, their one chunk
    padded to max_chunks."""
    jb, tb, _, _ = stick
    jr, jplans, _ = pushed["jax"]
    tr, tplans, _ = pushed["port"]
    for i in range(2):
        dj, dt = ([], [], []), ([], [], [])
        jb.envs[i]._eef_prev = tb.envs[i]._eef_prev = None
        jb.capture(i, jr, jplans, dj)
        tb.capture(i, tr, tplans, dt)
        assert 1 <= len(dt[0]) == len(dj[0]) <= tb.envs[i].max_chunks
        assert len(dt[0]) == len(dt[1]) == len(dt[2])
        for a, b in zip(dt[1], dj[1]):
            _close(a, b, _ATOL)
        if i == 0:  # the parked tool is where its IK track put it (_held)
            for a, b in zip(dt[2], dj[2]):
                _close(a, b, 1e-5)
            _images_close(dt[0], dj[0])


def test_render_all_matches_jax_on_the_same_state(stick, pushed):
    """render_all of both packages on the same particles and shape poses
    (JAX's, copied into the port's envs): env 0's geometry posed by each
    env's shapes, at GATE_RES."""
    jb, tb, _, _ = stick
    for i, env in enumerate(tb.envs):
        p, sh = env.state.particles, env.state.shapes
        env.state = env.state._replace(
            particles=p._replace(pos=torch.as_tensor(
                np.array(jb.states.particles.pos[i]))),
            shapes=sh._replace(
                pos=torch.as_tensor(np.array(jb.states.shapes.pos[i])),
                quat=torch.as_tensor(np.array(jb.states.shapes.quat[i]))))
    t, j = tb.render_all(), np.asarray(jb.render_all())
    assert t.shape == j.shape == (2, 180, 180, 5)
    assert (j[..., 4] > 0).any() and not np.array_equal(t[0], t[1])
    # the pushed env's stick ends upright, seen almost end-on: its ray
    # quadratic is ill-conditioned there (8.4e-4 in depth measured), so
    # frames are held as the lone env's rendered observation is
    # (tests/test_torch_sim.py::test_push_matches_jax, 1e-3); the parked
    # env's within 1e-5 of the value off the depth silhouettes
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-3)
    sil = trender.silhouette_pixels(j[1, ..., 4])
    off = (np.abs(t[1] - j[1]) > 1e-5 * np.maximum(np.abs(j[1]), 1.0)).any(-1)
    assert not (off & ~sil).any()
    for i in range(2):
        assert (tbatch.color_diff_valid(t[0], t[i])
                == jbatch.color_diff_valid(None, j[0], j[i]))


def test_gripper_batch_restores_inv_mass(gripper):
    """A grasp in the batch pins the nearest particles for the push and the
    bookkeeping restores their inverse masses. JAX restores them on each
    env's own view only (batch_env.py:254-258): its stacked states, which
    the next push runs from, keep them pinned. The port's envs run from
    their own states, so the restore holds there (ROADMAP Queue 3)."""
    jb, tb, _, _ = gripper
    jb.reset([11, 12])
    tb.reset([11, 12])
    w0 = tb.envs[0]._inv_mass0
    act = np.array([0.0, 0.0, 0.8, 0.3])
    jr, jplans, jnan = jb.run_pushes([act, None])
    tr, tplans, tnan = tb.run_pushes([act, None])
    assert not tnan.any() and not jnan.any()
    assert tplans[0]["attach_active"].max() == 1.0
    assert tplans[1]["attach_active"].max() == 0.0
    _close(tr, jr, _ATOL)
    for i in range(2):
        np.testing.assert_array_equal(
            tb.envs[i].state.particles.inv_mass.numpy(), tb.envs[i]._inv_mass0)
        np.testing.assert_array_equal(
            tb.envs[i].state.particles.inv_mass.numpy(),
            np.asarray(jb.envs[i].state.particles.inv_mass))
    grasped = np.unique(tplans[0]["attach_idx"])
    assert (w0[grasped] > 0).all()
    assert (np.asarray(jb.states.particles.inv_mass[0])[grasped] == 0).all()


def test_generate_batch_matches_jax_through_h5(stick, tmp_path):
    """generate_batch of both packages: one push for each of two envs. The
    port's NN.npz written to h5 by JAX's save_data and read back by JAX's
    load_data equals the port's episode; against JAX's own episode the
    positions are within 1e-4 and the captures equal but for values off
    by one."""
    jb, _, cfg, mp = stick
    # JAX's generate_batch takes the fixture's BatchSimEnv: its programs
    # are compiled once for the module
    mp.setattr(jbatch, "BatchSimEnv", lambda config, batch: jb)
    jbatch.generate_batch(Config(cfg), list(SEEDS), str(tmp_path / "jax"),
                          n_timestep=1)
    tb = tbatch.generate_batch(cfg, list(SEEDS), str(tmp_path / "port"),
                               n_timestep=1, device="cpu")
    st = tb.episode_stats
    assert st["stuck"] == [False, False] and st["attempts"] == [[1], [1]]
    # JAX's own spread: its batch from the same reset, the episodes'
    # actions and the actions nudged by 1e-6
    acts = [jio.load_data(str(tmp_path / "jax" / "rope" / f"{s:06}" / "01.h5")
                          )["action"] for s in SEEDS]
    recs = []
    for nudge in (0.0, 1e-6):
        jb.reset(list(SEEDS))
        recs.append(np.asarray(jb.run_pushes([a + nudge for a in acts])[0]))
    spread = dict(zip(SEEDS, np.abs(recs[1] - recs[0]).max(axis=(1, 2, 3))))
    for seed in SEEDS:
        tdir = tmp_path / "port" / "rope" / f"{seed:06}"
        jdir = tmp_path / "jax" / "rope" / f"{seed:06}"
        assert sorted(os.listdir(tdir)) == ["00.npz", "01.npz",
                                            "property_params.pkl"]
        assert tio.load_property_params(str(tdir)) == \
            jio.load_property_params(str(jdir))
        # the settled scene within 1e-4 and its captures equal but for
        # values off by one; the push's action is sampled from positions
        # within 1e-4 (its start the same draw, its end within 1e-5), and
        # its frames are held to 3x JAX's own spread under a 1e-6 nudge of
        # that action (seed 8's push is chaotic: 0.34 in JAX itself; the
        # port sits 0.16 from JAX), and to 1e-4 at least
        for step in ("00", "01"):
            t = tio.load_data(str(tdir / f"{step}.npz"))
            jio.save_data(str(tmp_path / "copy.h5"), t)
            back = jio.load_data(str(tmp_path / "copy.h5"))
            for key in ("positions", "eef_states", "action"):
                np.testing.assert_array_equal(back[key], t[key])
            j = jio.load_data(str(jdir / f"{step}.h5"))
            np.testing.assert_array_equal(t["action"][:2], j["action"][:2])
            np.testing.assert_allclose(t["action"], j["action"], rtol=0,
                                       atol=1e-5)
            assert t["positions"].shape == j["positions"].shape
            atol = 1e-4 if step == "00" else max(1e-4, 3 * spread[seed])
            np.testing.assert_allclose(t["positions"], j["positions"],
                                       rtol=0, atol=atol)
            if step == "01":
                continue
            np.testing.assert_allclose(t["eef_states"], j["eef_states"],
                                       rtol=0, atol=1e-5)
            for kind in ("color", "depth"):
                for cam in j["observations"][kind]:
                    a = t["observations"][kind][cam]
                    b = j["observations"][kind][cam]
                    _images_close([(a, a)], [(b, b)])
    for cam in ("intrinsic", "extrinsic"):
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "rope" / "cameras" / f"{cam}.npy"),
            np.load(tmp_path / "jax" / "rope" / "cameras" / f"{cam}.npy"))


# ---------- env 0 against a lone SimEnv ----------

def _lone_push(cfg, seed, action):
    env = tenv.SimEnv(cfg, device="cpu")
    env.bucket_caps = False
    env.reset(seed=seed)
    settled = env.state.particles.pos.clone()
    plan = env.plan_push(action)
    n = min(-(-(plan["t_push"] + env.settle_steps) // tenv.CHUNK),
            env.max_chunks)
    _, rec, _, _, bad = env._push_fn(
        env.state, env.spec, plan["eef"], plan["rot"], plan["gap"],
        plan["attach_idx"], plan["attach_rel"], plan["attach_active"],
        n_chunks_active=n, link_pos_traj=plan["link_pos"],
        link_quat_traj=plan["link_quat"])
    return settled, rec[:n], bad


def test_env0_equals_a_lone_simenv_bit_for_bit(stick, pushed):
    """Nothing re-padded: env 0's settle and push records equal a lone
    SimEnv's of the same seed and action bit for bit (the batch's parked
    settle moves its tool far above, the lone one parks it: neither
    touches the block)."""
    _, tb, cfg, _ = stick
    assert tb.repadded == [False, False]
    rec_b, _, nan_b = pushed["port"]
    settled, rec, bad = _lone_push(cfg, SEEDS[0], PUSH)
    assert torch.equal(pushed["reset"][0][0].particles.pos, settled)
    assert not nan_b.any() and not bad[0]
    assert np.array_equal(rec_b[0], rec)
