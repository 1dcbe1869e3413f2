"""Port parity: the closed planning loop (planning/plan.py's SimPlanEnv and
plan(), planning/random_interact.py) against the JAX package on the CPU.

The scene is tests/test_torch_sim.py's tiny block with the arm (each
package's build_scene monkeypatched), rendered by 4 cameras at 96 x 96.
- SimPlanEnv.get_obs: the port's frames within 1e-5 x max(1, value) of
  JAX's off the depth silhouettes; the perceived cloud near the block only.
- plan() of both packages through one env double that replays frames
  recorded from JAX's SimPlanEnv (the block, then moved twice)
  and records the actions it is given, with the rope checkpoint on both
  sides (JAX's DynDataset, init_model and load_checkpoint monkeypatched to
  hand plan() the restored weights; params_from_jax carries them across),
  JAX's per-action draws replayed through the port's noise_hook, and the
  global numpy stream (perception's FPS start) seeded alike: 2 actions in
  pcd mode with the physics estimate on (the target the first frame's
  cloud moved by 0.15, in the form plan() reads), 1 in box mode, 1 in
  change mode.
  Held within 1e-5: the actions, stats.txt and interaction_*.npz; the
  estimate and its errors (ppo_*.npz) within 1e-5, as the PR 10 optimiser
  tests hold them.
- Two faults of the JAX package that the port keeps: a goal captured from
  the simulator is planned toward 10x too far out and mirrored in z, and
  change mode picks the push that changes the state least.
The port-only cases (resume, the real-units branch, random_interact, the
device rule, the smoke's rehearsal) are tests/test_torch_loop.py.
The task is configs/planning/rope.yaml at max_nobj 32, fps_radius 0.05 (the
block is 0.24 across), repeats 5-7, 12 samples in chunks of 5 (12 is no
multiple of the 8 virtual CPU devices, so JAX plans without a mesh).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adaptigraph_tpu.planning.plan as jplan
import adaptigraph_tpu.sim.env as jenv
import adaptigraph_torch.planning.plan as tplan
import adaptigraph_torch.sim.env as tenv
from adaptigraph_tpu.dynamics.model import DynamicsPredictor as JModel
from adaptigraph_tpu.dynamics.model import (
    model_config_from_yaml as j_model_config)
from adaptigraph_tpu.dynamics.train import load_checkpoint
from adaptigraph_tpu.ops import build_edges_slotted as j_slotted
from adaptigraph_tpu.ops import chamfer as j_chamfer
from adaptigraph_tpu.planning import costs as jc
from adaptigraph_tpu.utils import Config
from adaptigraph_tpu.utils import load_config as j_load_config
from adaptigraph_torch.dynamics import DynamicsPredictor
from adaptigraph_torch.dynamics.model import (model_config_from_yaml,
                                              params_from_jax)
from adaptigraph_torch.ops import chamfer as t_chamfer
from adaptigraph_torch.planning.perception import PerceptionModule as TPM
from adaptigraph_torch.sim import render as trender
from adaptigraph_torch.utils import load_config as t_load_config
from tests.test_torch_sim import TINY, patch_tiny

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ATOL = 1e-5
OBS = dict(TINY, screenWidth=96, screenHeight=96, max_chunks=4,
           settle_steps=20, robot_speed_inv=20)
SEED = 3
MOVES = ((0.12, 0.0, -0.06), (0.05, 0.0, 0.15))  # the block between frames
N_SAMPLE, CHUNK = 12, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(port, ref, atol=_ATOL):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=atol)


# ---------------------------------------------------------------- the scene


def _unsettled(reset):
    def build(self, seed=0, save_data=False, settle=True):
        reset(self, seed, save_data, settle=False)
        return self.finish_reset(save_data=save_data)
    return build


@pytest.fixture(scope="module")
def sim():
    """Both packages' SimPlanEnv on the tiny block (seed 3) as built (the
    settle skipped: tests/test_torch_sim.py holds it), and three frames of
    JAX's: the block, then the block moved by each of MOVES in turn (its
    particles placed, no push: a replayed frame needs no physics)."""
    with pytest.MonkeyPatch.context() as mp:
        patch_tiny(mp)
        for mod in (jenv, tenv):  # the block as built: no settle to compile
            mp.setattr(mod.SimEnv, "reset", _unsettled(mod.SimEnv.reset))
        je = jplan.SimPlanEnv(Config({"dataset": dict(OBS)}), seed=SEED)
        te = tplan.SimPlanEnv({"dataset": dict(OBS)}, seed=SEED, device="cpu")
        first = [tuple(np.asarray(x) for x in je.get_obs()), te.get_obs()]
        frames = [first[0]]
        st = je.env.state
        pos = np.asarray(st.particles.pos)
        for move in MOVES:
            pos = pos + np.asarray(move, np.float32) * (
                np.arange(len(pos)) < je.env.n_active)[:, None]
            je.env.state = st._replace(particles=st.particles._replace(
                pos=jnp.asarray(pos)))
            frames.append(tuple(np.asarray(x) for x in je.get_obs()))
        yield dict(jax=je, port=te, first=first, frames=frames,
                   intr=je.cam_intr, extr=je.cam_extr,
                   particles=te.env.get_positions())


class FramesEnv:
    """The planning-env double: get_obs replays frame k after k steps (the
    last one beyond), step records the action."""

    def __init__(self, frames, intr, extr, start=0, units="sim", scale=1.0):
        self.frames, self.k, self.actions = frames, start, []
        self.cam_intr, self.cam_extr = intr, extr
        self.units, self.scale = units, scale

    def get_obs(self):
        c, d = self.frames[min(self.k, len(self.frames) - 1)]
        return c.copy(), d.copy() * self.scale

    def step(self, action):
        self.actions.append(np.asarray(action, np.float64))
        self.k += 1
        return True


def test_get_obs_matches_jax_and_hides_the_tool_and_arm(sim):
    (cj, dj), (ct, dt) = sim["first"]
    assert ct.shape == (4, 96, 96, 3) and dt.shape == (4, 96, 96)
    assert sim["port"].env.n_arm > 0
    fj = np.concatenate([cj, dj[..., None]], -1)
    ft = np.concatenate([ct, dt[..., None]], -1)
    sil = np.stack([trender.silhouette_pixels(d) for d in dj])
    off = (np.abs(ft - fj) > _ATOL * np.maximum(np.abs(fj), 1.0)).any(-1)
    assert not (off & ~sil).any()
    task = {"fps_radius": 0.05, "max_nobj": 32, "k_filter": 1.0}
    pts = TPM(task).get_tabletop_points(ct, dt, sim["port"].cam_intr,
                                        sim["port"].cam_extr)
    assert len(pts) > 10
    d = np.linalg.norm(pts[:, None] - sim["particles"][None], axis=-1).min(1)
    assert d.max() < 0.5
    # the arm's hulls and the tool, were they rendered, would be perceived
    env = sim["port"].env
    imgs = env._render_multiview(env.state.particles.pos.numpy())
    full = TPM(task).get_tabletop_points(imgs[..., :3], imgs[..., 4],
                                         sim["port"].cam_intr,
                                         sim["port"].cam_extr)
    dd = np.linalg.norm(full[:, None] - sim["particles"][None],
                        axis=-1).min(1)
    assert dd.max() > 0.5


def test_double_frames_move_the_block(sim):
    task = {"fps_radius": 0.05, "max_nobj": 32, "k_filter": 1.0}
    states = [TPM(task).get_state_cur(c, d, sim["intr"], sim["extr"],
                                      rng=np.random.RandomState(0))[0]
              for c, d in sim["frames"]]
    assert all(10 < len(s) <= 32 for s in states)
    for a, b in zip(states, states[1:]):
        assert float(t_chamfer(torch.as_tensor(a), torch.as_tensor(b))) > 0.02


# ------------------------------------------------------- the rope checkpoint


@pytest.fixture(scope="module")
def rope():
    """The rope checkpoint restored on the JAX side (its restore target
    from jax.eval_shape: no JAX init compile), carried across by
    params_from_jax."""
    jdyn = j_load_config("dynamics/rope")
    jmodel = JModel(j_model_config(jdyn["model_config"],
                                   jdyn["dataset_config"], 1))
    n = 30
    state = np.random.RandomState(0).rand(n, 3).astype(np.float32)
    full = jnp.tile(jnp.concatenate([jnp.asarray(state),
                                     jnp.zeros((1, 3))])[None], (4, 1, 1))
    tools = jnp.zeros(n + 1, bool).at[n:].set(True)
    e = j_slotted(full[-1], 0.5, jnp.ones(n + 1, bool), tools, topk=5)
    args = (full, jnp.zeros((n + 1, 2)), e.receivers, e.senders, e.valid,
            jnp.ones((n, 1)), jnp.array([0.5]))
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    params_like = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=one),
        jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), *args,
            action=jnp.zeros((n + 1, 3)))["params"]))
    ckpt = os.path.join(_ROOT, "data", "log", "rope", "checkpoints")
    jparams = load_checkpoint(ckpt, "latest", params_like)
    tdyn = t_load_config("dynamics/rope")
    tcfg = model_config_from_yaml(tdyn["model_config"],
                                  tdyn["dataset_config"], 1)
    model = DynamicsPredictor(tcfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    model.load_state_dict(params, strict=True)
    return dict(jmodel=jmodel, jparams=jparams, params=params)


def _task(**over):
    task = dict(t_load_config("planning/rope")["task_config"], max_nobj=32,
                fps_radius=0.05, n_sample_chunk=CHUNK,
                action_lower_lim=[-2.0, -2.0, -3.14, 5],
                action_upper_lim=[2.0, 2.0, 3.14, 7])
    task.update(over)
    return task


def _key_draws(key):
    """A Planner noise_fn replaying JAX's MPPI draws from `key`
    (planner.py's split an iteration, actions.py's uniform and normal
    blocks)."""
    key = [key]

    def draw(i, n_sample, n_look, adim):
        key[0], sub = jax.random.split(key[0])
        if i == 0:
            return torch.as_tensor(np.array(jax.random.uniform(
                sub, (n_sample, n_look, adim))))
        keys = jax.random.split(sub, n_look)
        return torch.as_tensor(np.stack([np.asarray(jax.random.normal(
            k, (n_sample, 4))) for k in keys]))
    return draw


def jax_hook(seed, start=0):
    """The port's noise_hook replaying plan.py's per-action keys: JAX's
    loop splits PRNGKey(seed) once an action from the run's first action
    `start` (a resumed run starts its chain again)."""
    def hook(i):
        key = jax.random.PRNGKey(seed)
        for _ in range(i - start + 1):
            key, sub = jax.random.split(key)
        return _key_draws(sub)
    return hook


def run_both(rope, sim, tmp_path, task, monkeypatch, n_actions,
             reward_mode="target", use_ppo=False, start=0, frames=None,
             resume=False):
    """plan() of both packages through FramesEnv doubles; returns
    {side: (save_dir, double)}."""
    monkeypatch.setattr(jplan, "DynDataset", lambda *a: None)
    monkeypatch.setattr(jplan, "init_model",
                        lambda cfg, ds: (rope["jmodel"], None))
    monkeypatch.setattr(jplan, "load_checkpoint",
                        lambda d, name, like: rope["jparams"])
    monkeypatch.setenv("PPO_ITERS", "3")
    frames = frames or sim["frames"]
    out = {}
    for side in ("jax", "port"):
        save = str(tmp_path / side)
        env = FramesEnv(frames, sim["intr"], sim["extr"], start=start)
        np.random.seed(11)  # perception's FPS start: the global stream
        kw = dict(use_ppo=use_ppo, n_actions=n_actions, n_sample=N_SAMPLE,
                  n_update_iter=2, resume=resume, seed=5,
                  reward_mode=reward_mode)
        if side == "jax":
            jplan.plan(task, env, save, **kw)
        else:
            tplan.plan(task, env, save, rope["params"], device="cpu",
                       noise_hook=jax_hook(5, start), **kw)
        out[side] = (save, env)
    return out


def _hold(out, n_actions, first=0):
    (sj, ej), (st, et) = out["jax"], out["port"]
    assert len(et.actions) == len(ej.actions) == n_actions - first
    for a, b in zip(et.actions, ej.actions):
        _close(a, b)
    stj, stt = (np.loadtxt(os.path.join(s, "stats.txt"), ndmin=2)
                for s in (sj, st))
    assert stt.shape == stj.shape == (n_actions - first, 4)
    assert np.isfinite(stt).all()
    _close(stt, stj)
    for i in range(first, n_actions):
        dj, dt = (np.load(os.path.join(s, f"interaction_{i:03}.npz"))
                  for s in (sj, st))
        assert sorted(dt.files) == sorted(dj.files) == [
            "act", "state_init", "state_pred", "state_real"]
        for k in dt.files:
            assert dt[k].shape == dj[k].shape
            _close(dt[k], dj[k])
    return stt


def goal_as_plan_reads_it(goal, shift=(0.0, 0.0, 0.0), ratio=10.0):
    """A cloud captured from the simulator (flex frame, sim units) in the
    form plan() reads a pcd target: moved by `shift` in the plan frame,
    mirrored back to the flex frame and divided by sim_real_ratio
    (scripts/plan_acceptance.py builds its targets so)."""
    plan_pts = tplan.flex_to_plan(goal) + np.asarray(shift, np.float32)
    return tplan.flex_to_plan(plan_pts) / ratio


@pytest.fixture(scope="module")
def pcd_run(rope, sim, tmp_path_factory):
    """2 actions toward the double's first frame moved by 0.15 along x,
    with the estimate on."""
    tmp = tmp_path_factory.mktemp("pcd")
    env = FramesEnv(sim["frames"], sim["intr"], sim["extr"])
    goal = tplan.capture_goal(env, TPM(_task()))
    path = str(tmp / "target.npy")
    np.save(path, goal_as_plan_reads_it(goal, (0.15, 0.0, 0.0)))
    task = _task(target_type="pcd", target=path)
    with pytest.MonkeyPatch.context() as mp:
        out = run_both(rope, sim, tmp, task, mp, 2, use_ppo=True)
    return dict(out=out, task=task)


def test_plan_pcd_mode_with_ppo_matches_jax(pcd_run):
    out = pcd_run["out"]
    stats = _hold(out, 2)
    assert list(stats[:, 0]) == [0, 1]
    for i in range(2):
        pj, pt = (np.load(os.path.join(out[s][0], f"ppo_{i}.npz"))
                  for s in ("jax", "port"))
        _close(pt["physics_param"], pj["physics_param"])
        for k in ("error", "error_init"):
            assert abs(float(pt[k]) - float(pj[k])) <= _ATOL
        assert np.float32(-0.2) <= pt["physics_param"][0] <= np.float32(1.2)


def test_sim_mode_capture_goal_is_planned_10x_out_and_mirrored(
        rope, sim, tmp_path, monkeypatch):
    """Kept from the JAX package: plan() multiplies a loaded pcd target by
    sim_real_ratio and never negates its z, while capture_goal saves the
    perceived cloud in the flex frame in sim units (as `plan.py
    --capture-goal` does). In both packages the real final error in
    stats.txt is the chamfer distance to that misplaced goal; mirrored
    and left at scale, the goal sits near the perceived block."""
    env = FramesEnv(sim["frames"], sim["intr"], sim["extr"])
    goal_path = str(tmp_path / "goal.npy")
    goal = tplan.capture_goal(env, TPM(_task()), goal_path)
    task = _task(target_type="pcd", target=goal_path)
    out = run_both(rope, sim, tmp_path, task, monkeypatch, 1)
    errs = []
    for side in ("jax", "port"):
        save = out[side][0]
        log = np.load(os.path.join(save, "interaction_000.npz"))
        stats = np.loadtxt(os.path.join(save, "stats.txt"), ndmin=2)
        as_planned = float(j_chamfer(jnp.asarray(log["state_real"])[None],
                                     jnp.asarray(goal * 10.0)[None])[0])
        assert abs(as_planned - stats[0, 2]) <= _ATOL
        # the goal was captured from the frame action 0 started from
        init = torch.as_tensor(log["state_init"])
        meant = float(t_chamfer(init, torch.as_tensor(
            tplan.flex_to_plan(goal))))
        planned = float(t_chamfer(init, torch.as_tensor(goal * 10.0)))
        assert meant < 0.1 and planned > 10 * meant
        errs.append(stats[0, 2])
    assert abs(errs[0] - errs[1]) <= _ATOL


@pytest.mark.parametrize("mode", ["box", "change"])
def test_plan_box_and_change_modes_match_jax(rope, sim, tmp_path,
                                             monkeypatch, mode):
    task = _task(target_type="box", target=[-0.05, 0.05, -0.05, 0.05])
    out = run_both(rope, sim, tmp_path, task, monkeypatch, 1,
                   reward_mode="change" if mode == "change" else "target")
    stats = _hold(out, 1)
    if mode == "change":  # the final error is minus the real change
        assert stats[0, 2] < 0 and stats[0, 3] < 0


def _change_population():
    """A current state and 6 predicted states that move it by growing
    amounts, each sample's push starting far from the object."""
    rng = np.random.RandomState(0)
    cur = np.zeros((10, 3), np.float32)
    cur[:, 0] = np.linspace(-0.5, 0.5, 10)
    cur[:, 1] = 0.6
    shifts = np.array([0.3, 0.05, 0.6, 0.01, 0.2, 0.4], np.float32)
    states = (cur[None, None] + shifts[:, None, None, None]
              * rng.randn(6, 1, 10, 3).astype(np.float32))
    acts = np.tile(np.array([[[3.0, 3.0, 0.0, 5.0]]], np.float32), (6, 1, 1))
    return cur, states, acts, shifts


def test_change_mode_picks_the_least_change_in_both_packages():
    """Kept from the JAX package: change mode's error is minus the
    chamfer distance from the current state, so the population's weight
    2 / (max error + 1e-6) is negative and the best reward goes to the
    sample that changes the state least (penalties zero here)."""
    cur, states, acts, shifts = _change_population()
    mask = np.ones(10, bool)
    task = _task(target_type="box", target=[-0.05, 0.05, -0.05, 0.05],
                 bbox=[-5, 0, -5, 5, 0, 5], n_sample_chunk=4)
    r = tplan.make_reward(task, "change", "cpu")
    cur_t = torch.as_tensor(cur)
    ev_t = r.evaluate(torch.as_tensor(states), torch.as_tensor(acts), cur_t,
                      torch.as_tensor(mask), cur_t, torch.as_tensor(mask))
    bbox = jnp.asarray(np.array([[-50, 50], [-50, 50]], np.float32))

    def err(flat, mflat):  # plan.py's change-mode error
        return -j_chamfer(flat, jnp.asarray(cur)[None], x_mask=mflat,
                          y_mask=jnp.asarray(mask)[None])

    ev_j = jc.chunked_cost(jnp.asarray(states), jnp.asarray(acts),
                           jnp.asarray(cur), err, jc.PENALTIES["rope"], bbox,
                           obj_mask=jnp.asarray(mask), n_chunk=4)
    change = -_np(ev_t["error_seqs"])
    assert (change > 0).all()
    for ev in (ev_t, ev_j):
        rewards = _np(ev["reward_seqs"])
        assert int(np.argmax(rewards)) == int(np.argmin(change)) == int(
            np.argmin(shifts))
        # the weight is negative: reward = (2 / (max error + 1e-6)) * change
        w = 2.0 / (float(np.max(-change)) + 1e-6)
        assert w < 0
        np.testing.assert_allclose(rewards, w * change, rtol=1e-5)
    np.testing.assert_allclose(_np(ev_t["reward_seqs"]),
                               _np(ev_j["reward_seqs"]), rtol=1e-5)
