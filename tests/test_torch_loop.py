"""The closed planning loop's port-only cases on the CPU: planning/plan.py's
resume, its `units == 'real'` branch, random_interact.main, the device
rule, and chip_smoke.py's loop_path rehearsed at a tiny size.

The JAX parity of plan() itself is tests/test_torch_plan.py; these cases
hold the port to what that file pins (the JAX package's resume semantics,
its meter-scale perception) or to itself. The env double replays frames of
the port's SimPlanEnv on tests/test_torch_sim.py's tiny block (the block
settled, then moved twice); the weights are a seeded init of the rope
config's model (configs/dynamics/rope.yaml), so no checkpoint is read.
"""

import os

import numpy as np
import pytest
import torch

import adaptigraph_tpu.planning.plan as jplan
import adaptigraph_torch.planning.plan as tplan
from adaptigraph_tpu.planning.perception import PerceptionModule as JPM
from adaptigraph_torch.dynamics import DynamicsPredictor
from adaptigraph_torch.dynamics.model import model_config_from_yaml
from adaptigraph_torch.planning import random_interact
from adaptigraph_torch.utils import load_config
from tests.test_torch_plan import MOVES, N_SAMPLE, OBS, SEED, FramesEnv, _task
from tests.test_torch_sim import patch_tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim():
    """The port's SimPlanEnv on the tiny block (seed 3) and three of its
    frames: the settled block, then the block moved by each of MOVES."""
    with pytest.MonkeyPatch.context() as mp:
        patch_tiny(mp)
        te = tplan.SimPlanEnv({"dataset": dict(OBS)}, seed=SEED, device="cpu")
        frames = [te.get_obs()]
        st = te.env.state
        active = (torch.arange(st.particles.pos.shape[0])
                  < te.env.n_active)[:, None]
        pos = st.particles.pos
        for move in MOVES:
            pos = pos + torch.tensor(move) * active
            te.env.state = st._replace(particles=st.particles._replace(
                pos=pos))
            frames.append(te.get_obs())
        yield dict(port=te, frames=frames, intr=te.cam_intr,
                   extr=te.cam_extr)


@pytest.fixture(scope="module")
def rope():
    """A seeded init of the rope config's model: {'params': state_dict}."""
    dyn = load_config("dynamics/rope")
    cfg = model_config_from_yaml(dyn["model_config"], dyn["dataset_config"],
                                 1)
    model = DynamicsPredictor(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    return {"params": dict(model.state_dict())}


def test_resume_repeats_the_uninterrupted_run(rope, sim, tmp_path,
                                              monkeypatch):
    """A run resumed after one logged action plans action 1 only (the
    index taken from the interaction_*.npz count), seeds the estimate from
    ppo_0.npz and writes stats.txt anew with its own rows, as JAX's plan()
    does; and since the port's draws for action i depend on (seed, i)
    only, it plans what the uninterrupted run planned, bit for bit."""
    monkeypatch.setenv("PPO_ITERS", "2")
    task = _task(target_type="box", target=[-0.05, 0.05, -0.05, 0.05])
    runs = {}
    for name, spans in (("whole", [(0, 2)]), ("resumed", [(0, 1), (1, 2)])):
        save = str(tmp_path / name)
        np.random.seed(0)  # perception's FPS starts, one stream a run
        acts = []
        for lo, hi in spans:
            env = FramesEnv(sim["frames"], sim["intr"], sim["extr"], start=lo)
            tplan.plan(task, env, save, rope["params"], use_ppo=True,
                       n_actions=hi, n_sample=6, resume=lo > 0,
                       device="cpu")
            acts += env.actions
        runs[name] = (save, acts)
    (sw, aw), (sr, ar) = runs["whole"], runs["resumed"]
    assert len(aw) == len(ar) == 2
    np.testing.assert_array_equal(np.stack(aw), np.stack(ar))
    stw, str_ = (np.loadtxt(os.path.join(s, "stats.txt"), ndmin=2)
                 for s in (sw, sr))
    assert stw.shape == (2, 4) and str_.shape == (1, 4)
    np.testing.assert_array_equal(str_[0], stw[1])
    for f in ("interaction_001.npz", "ppo_1.npz"):
        dw, dr = (np.load(os.path.join(s, f)) for s in (sw, sr))
        for k in dw.files:
            np.testing.assert_array_equal(dw[k], dr[k])


def test_real_units_branch(rope, sim, tmp_path):
    """units == 'real': the frames in meters (depths / 10) perceived with
    the meter-scale module (the task's bbox as the workspace, voxel
    0.002, the task's table height; fps_radius in meters), then scaled by
    sim_real_ratio."""
    task = _task(target_type="box", target=[-0.05, 0.05, -0.05, 0.05],
                 bbox=[-0.3, 0.0, -0.3, 0.3, 0.2, 0.3], table_height=0.032,
                 fps_radius=0.005)
    extr = sim["extr"].copy()
    extr[:, :3, 3] /= 10.0  # the cameras' positions in meters
    env = FramesEnv(sim["frames"], sim["intr"], extr, units="real",
                    scale=0.1)
    np.random.seed(2)
    tplan.plan(task, env, str(tmp_path), rope["params"], n_actions=1,
               n_sample=N_SAMPLE, device="cpu")
    log = np.load(tmp_path / "interaction_000.npz")
    c, d = sim["frames"][0]
    np.random.seed(2)
    bb = np.asarray(task["bbox"], np.float32).reshape(2, 3)
    pm = JPM(task, table_height=0.032, voxel=0.002,
             workspace=np.stack([bb.min(0), bb.max(0)], axis=1))
    st, _ = pm.get_state_cur(c, d * 0.1, sim["intr"], extr)
    expect = jplan.flex_to_plan(st * 10.0)
    assert 10 < len(expect) <= 32
    np.testing.assert_array_equal(log["state_init"], expect)
    # meters back to sim units: the block where the sim frames put it
    assert np.abs(log["state_init"][:, 1] - 0.6).max() < 0.15


def test_random_interact_main_on_the_cpu(rope, sim, tmp_path, monkeypatch):
    """random_interact.main: the rope task (as the file's other cases cut
    it) in change mode with the estimate on, its weights from --params,
    on --device cpu (the simulator replaced by the double)."""
    path = str(tmp_path / "rope.pt")
    torch.save(rope["params"], path)
    monkeypatch.setenv("PPO_ITERS", "2")
    made = []

    def double(tc, kind, device=None):
        assert kind == "sim" and device == torch.device("cpu")
        made.append(FramesEnv(sim["frames"], sim["intr"], sim["extr"]))
        return made[-1]

    monkeypatch.setattr(tplan, "make_env", double)
    monkeypatch.setattr(random_interact, "load_config",
                        lambda name: {"task_config": _task()})
    save = str(tmp_path / "ri")
    stats = random_interact.main(["--task-config", "planning/rope",
                                  "--params", path, "--n-actions", "1",
                                  "--n-sample", "8", "--name", save,
                                  "--device", "cpu"])
    assert len(stats) == 1 and len(made[0].actions) == 1
    assert stats[0][2] < 0  # change mode: minus the real change
    assert os.path.exists(os.path.join(save, "ppo_0.npz"))


def test_entry_points_raise_without_a_device(rope, sim, tmp_path,
                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = FramesEnv(sim["frames"], sim["intr"], sim["extr"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.plan(_task(), env, str(tmp_path), rope["params"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.SimPlanEnv({"dataset": dict(OBS)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.main(["--params", "none.pt", "--name", str(tmp_path)])
    # the real environment is built now; its arm driver needs the xArm SDK
    with pytest.raises(ImportError, match="xarm"):
        tplan.main(["--env", "real", "--device", "cpu"])


def test_smoke_loop_path_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's loop phases, rehearsed with the CPU in the card's
    place on the tiny block (its lattice closer than the contact distance)
    forced into the block contact mode (so K1 and K2's plain versions run
    where the card launches the kernels, counted at the solver's
    wrappers), at 12 samples in chunks of 5 and max_nobj 40: every gate
    holds, as card and CPU are then one device."""
    import chip_smoke as cs
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine import solver

    patch_tiny(monkeypatch, spacing=0.025)
    monkeypatch.setattr(solver, "auto_contact_mode", lambda n: "block")
    for name in ("block_sparse_contact_deltas_packed",
                 "refine_overlap_blocks_packed", "dense_contact_deltas_packed"):
        real = getattr(ck, name)

        def counted(*a, _real=real, **k):
            _real.launches += 1
            return _real(*a, **k)

        monkeypatch.setattr(solver, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    # the card's LOOP_SEED meets the rope; the tiny run's push is not asked to
    monkeypatch.setattr(cs, "LOOP_PUSHED", 0.0)
    out = cs.loop_phases("cpu", config={"dataset": dict(OBS)}, seed=SEED,
                         n_sample=12, task_over={
                             "max_nobj": 40, "n_sample_chunk": 5,
                             "fps_radius": 0.05})
    counts = out["counts"]
    assert counts["k2"] == out["push_frames"] > 0
    assert counts["k1"] == 4 * counts["k2"]
    assert counts["k3"] == counts["k4"] == 0
    assert out["card_vs_cpu_state_max"] == 0.0
    assert set(out["seconds_per_action"]) == {
        "observe", "perceive", "plan", "push", "log", "ppo_refit"}
