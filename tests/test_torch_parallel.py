"""Port parity: the 1-D data mesh (adaptigraph_torch/parallel/mesh.py) and
its callers, train(), the Planner and plan(), across two gloo ranks on the
CPU, against JAX's mesh of two devices and against one process.

The ranks are two processes started once for the file (the `ranks`
fixture): a process group over a FileStore under the test's temporary
directory (no TCP port), each rank on one thread, every collective under
COLLECTIVE_TIMEOUT_S, the spawn joined under SPAWN_TIMEOUT_S, after which
the ranks are killed and the fixture fails. Each rank runs every case in
turn (`_cases`) and pickles what it saw; the tests read those results.
The ranks import this module to find their target, so it imports JAX and
the JAX package inside its tests and fixtures only: the parent computes
JAX's references and hands the ranks numpy inputs.

Tolerances, as the JAX tests state them or tighter:
- shard_batch and replicate: equal;
- one data-parallel train step against JAX's make_train_step under
  make_mesh(2) (the params carried across by params_from_jax): the
  params after Adam within 1e-6, the loss within 1e-6 of itself; the
  ranks' params equal;
- train() on two ranks against one process: losses within rtol 1e-5,
  params within 1e-5 (the batch mean is summed in another order); the
  ranks equal;
- the Planner (tests/test_planning.py:166's population of 256, JAX's
  draws replayed through noise_fn): act_seq within 1e-5 of the meshless
  port run and of JAX's mesh run; GD likewise;
- plan() on two ranks against one process: the chosen push within 1e-5.
"""

import datetime
import os
import pickle
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from adaptigraph_torch.dynamics import train as tt
from adaptigraph_torch.parallel import mesh as pm
from adaptigraph_torch.planning.actions import decode_action
from adaptigraph_torch.utils import load_config

WORLD = 2
SPAWN_TIMEOUT_S = 240
COLLECTIVE_TIMEOUT_S = 120
LOWER = [-4.5, -2.5, -3.14, 2.0]  # tests/test_planning.py's action box
UPPER = [0.0, 4.5, 3.14, 10.0]
TARGET = (-2.0, 1.0)
N_SAMPLE = 256
PLAN_SAMPLES = 64
# train(): B 8 split over the ranks through 2-step chunks; B 7, which two
# ranks do not divide, whole on each through the host loop
TRAIN_RUNS = (("split", {}), ("whole", {"batch_size": 7}))


@contextmanager
def process_group(store, rank=0, world=1):
    """A gloo process group of `world` over a FileStore at `store`,
    destroyed on the way out."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(store), world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def one_rank_group(store):
    """A gloo process group of one process (for a mesh in this process)."""
    return process_group(store)


def _rank_main(rank, target, world, store, out_dir, inputs):
    torch.set_num_threads(1)
    with process_group(store, rank, world):
        result = target(rank, inputs)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def start(target, inputs, tmp, world=WORLD):
    """target(rank, inputs) started in `world` spawned processes under one
    process group; `finish` collects their results."""
    ctx = mp.start_processes(
        _rank_main, args=(target, world, str(tmp / "store"), str(tmp),
                          inputs),
        nprocs=world, join=False, start_method="spawn")
    return ctx, time.monotonic() + SPAWN_TIMEOUT_S


def finish(started, tmp):
    """Each rank's result. A rank that raised fails the call (the others
    are stopped); ranks still running SPAWN_TIMEOUT_S after their start
    are killed and the call fails."""
    ctx, deadline = started
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks ran past {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    out = []
    for r in range(len(ctx.processes)):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------ shared inputs


def write_episodes(root, n_episodes=4, n_obj=40, n_frames=24, seed=0):
    """A preprocessed rope dataset of `n_episodes` synthetic episodes under
    root (sim_data/rope/NNNNNN/property_params.pkl; preprocess/rope/
    positions.pkl and frame_pairs): a chain of n_obj particles 0.05 apart
    drifting along a seeded random walk, one tool point beside it. Returns
    the port's rope dynamics config pointed at it."""
    rng = np.random.RandomState(seed)
    prep = root / "preprocess" / "rope"
    (prep / "frame_pairs").mkdir(parents=True)
    obj_pos, eef_pos = [], []
    for e in range(n_episodes):
        name = f"{e:06d}"
        epi = root / "sim_data" / "rope" / name
        epi.mkdir(parents=True)
        with open(epi / "property_params.pkl", "wb") as f:
            pickle.dump({"stiffness": float(rng.rand())}, f)
        chain = np.zeros((n_obj, 3), np.float32)
        chain[:, 0] = np.arange(n_obj) * 0.05 - 1.0
        chain[:, 1] = 0.05
        walk = np.cumsum(rng.randn(n_frames, n_obj, 3) * 0.01, axis=0)
        obj_pos.append((chain[None] + walk).astype(np.float32))
        tool = np.stack([np.linspace(-1.0, 1.0, n_frames),
                         np.full(n_frames, 0.1), np.full(n_frames, 0.2)], -1)
        eef_pos.append(tool[:, None].astype(np.float32))
        rows = np.stack([np.arange(t, t + 7) for t in range(n_frames - 7)])
        np.savetxt(prep / "frame_pairs" / f"{name}_01.txt", rows, fmt="%d")
    with open(prep / "positions.pkl", "wb") as f:
        pickle.dump({"obj_pos": obj_pos, "eef_pos": eef_pos}, f)
    cfg = load_config("dynamics/rope")
    ds = dict(cfg["dataset_config"]["datasets"][0], max_nobj=32, max_nR=200)
    return cfg.override({
        "dataset_config": {"data_dir": str(root / "sim_data"),
                           "prep_data_dir": str(root / "preprocess"),
                           "datasets": [ds]},
        "model_config": {"nf_particle": 16, "nf_relation": 16,
                         "nf_effect": 16, "pstep": 2},
        "train_config": {"batch_size": 8, "n_epochs": 2, "log_interval": 50,
                         "n_iters_per_epoch": {"train": 4, "valid": 2}}})


def toy_rollout(seen=None):
    """tests/test_planning.py:166's model: each step's state is the
    decoded push's end point."""
    def model_rollout(state_cur, act_seqs):
        if seen is not None:
            seen.append(int(act_seqs.shape[0]))
        dec, _ = decode_action(act_seqs, push_length=0.2)
        end = dec[..., 2:]
        states = torch.cat([end, torch.zeros_like(end[..., :1])], -1)
        return {"state_seqs": states[:, :, None, :]}
    return model_rollout


def toy_evaluate(normalised=False):
    """Minus the end point's distance to TARGET; normalised: divided by
    the population's largest distance, as the planning reward's weight is
    (costs.assemble_reward), so each reward reads every row."""
    target = torch.tensor(TARGET)

    def evaluate(state_seqs, act_seqs, state_cur=None, **kw):
        d = torch.linalg.vector_norm(state_seqs[:, -1, 0, :2] - target,
                                     dim=-1)
        return {"reward_seqs": -d / d.max() if normalised else -d}
    return evaluate


def planner_config(kind, draws, mesh=None, seen=None, verbose=False):
    cfg = {"action_dim": 4, "model_rollout_fn": toy_rollout(seen),
           "evaluate_traj_fn": toy_evaluate(kind == "GD"),
           "n_sample": N_SAMPLE, "n_look_ahead": 1,
           "n_update_iter": 2 if kind == "MPPI" else 3,
           "reward_weight": 50.0, "action_lower_lim": LOWER,
           "action_upper_lim": UPPER, "planner_type": kind,
           "noise_level": 0.5, "push_length": 0.2, "lr": 0.05,
           "device": "cpu", "verbose": verbose, "mesh": mesh,
           "noise_fn": lambda i, *shape: torch.from_numpy(np.array(draws[i]))}
    return cfg


ACT0 = np.array([[-1.0, 0.0, 0.0, 5.0]], np.float32)


class FramesEnv:
    """A planning env replaying frame k after k pushes; records pushes."""

    def __init__(self, frames, intr, extr):
        self.frames, self.k, self.actions = frames, 0, []
        self.cam_intr, self.cam_extr, self.units = intr, extr, "sim"

    def get_obs(self):
        c, d = self.frames[min(self.k, len(self.frames) - 1)]
        return c.copy(), d.copy()

    def step(self, action):
        self.actions.append(np.asarray(action, np.float64))
        self.k += 1
        return True


def run_plan(inp, save_dir, env):
    from adaptigraph_torch.planning import plan as tplan

    np.random.seed(0)  # perception's FPS starts (rank 0 alone perceives)
    return tplan.plan(inp["task"], env, str(save_dir), inp["params"],
                      n_actions=1, n_sample=PLAN_SAMPLES, n_update_iter=2,
                      device="cpu")


# ---------------------------------------------------------- what a rank runs


def _cases(rank, inp):
    from torch.distributed.device_mesh import init_device_mesh

    from adaptigraph_torch.dynamics import DynamicsPredictor
    from adaptigraph_torch.dynamics.model import ModelConfig
    from adaptigraph_torch.planning import Planner
    from adaptigraph_torch.planning import plan as tplan

    out = {}
    mesh = pm.make_mesh(device="cpu")
    out["mesh"] = (mesh.size(), mesh.device_type, mesh.mesh_dim_names,
                   mesh.get_local_rank())

    # shard_batch and replicate
    local = pm.shard_batch(inp["tree"], mesh)
    out["shard"] = {k: np.asarray(v) for k, v in local.items()}
    mine = {"t": torch.full((3,), float(rank + 1)),
            "a": np.full(2, rank, np.int32), "o": {"r": rank},
            "b": torch.tensor([rank == 0])}
    rep = pm.replicate(mine, mesh)
    out["replicate"] = (rep, mine["t"].clone())

    # one data-parallel train step
    st = inp["step"]
    model = DynamicsPredictor(ModelConfig(n_his=4, nf=16, pstep=2),
                              device="cpu")
    model.load_state_dict(st["params"])
    opt, _ = tt.make_optimizer(model.parameters(), 1e-3)
    step, _ = tt.make_train_step(model, 3, opt, mesh=mesh)
    batch = pm.shard_batch({k: torch.as_tensor(v)
                            for k, v in st["batch"].items()}, mesh)
    loss = step(batch)
    out["step"] = {"loss": float(loss), "rows": batch["state"].shape[0],
                   "params": {k: v.clone()
                              for k, v in model.state_dict().items()}}

    # train(): the mesh taken from the world (mesh=None), rank-own out_dir
    tr = inp["train"]
    runs = {}
    for name, over in TRAIN_RUNS:
        base = os.path.join(tr["root"], f"{name}_rank{rank}")
        cfg = tr["cfg"].override({"train_config": dict(out_dir=base,
                                                       **over)})
        steps = 2 if name == "split" else None
        params, hist = tt.train(cfg, device="cpu", steps_per_call=steps)
        runs[name] = {"params": params, "history": hist,
                      "made": os.path.exists(base),
                      "files": sorted(os.listdir(os.path.join(base, "rope")))
                      if os.path.isdir(base) else None}
    out["train"] = runs

    # the Planner: MPPI (verbose) and GD over the mesh
    seen = {"MPPI": [], "GD": []}
    res = {}
    for kind in ("MPPI", "GD"):
        p = Planner(planner_config(kind, inp["draws"][kind], mesh,
                                   seen[kind], verbose=kind == "MPPI"))
        r = p.trajectory_optimization(torch.zeros((1, 3)), ACT0, seed=0)
        res[kind] = {"act_seq": r["act_seq"].numpy(), "seen": seen[kind]}
        if kind == "MPPI":
            res[kind]["verbose_rows"] = [
                (m["state_seqs"].shape[0], e["reward_seqs"].shape[0])
                for m, e in zip(r["model_outputs"], r["eval_outputs"])]
    out["planner"] = res
    out["planner_mesh"] = [None if m is None else m.size() for m in (
        tplan._planner_mesh(PLAN_SAMPLES, "cpu"),
        tplan._planner_mesh(PLAN_SAMPLES - 1, "cpu"))]

    # plan(): rank 0 drives the environment, rank 1 gets none
    pl = inp["plan"]
    save = os.path.join(pl["root"], f"plan_rank{rank}")
    env = FramesEnv(pl["frames"], pl["intr"], pl["extr"]) if rank == 0 \
        else None
    stats = run_plan(pl, save, env)
    out["plan"] = {"stats": stats,
                   "actions": None if env is None else env.actions,
                   "files": sorted(os.listdir(save))
                   if os.path.isdir(save) else None}

    # what the port refuses: another dim name, a mesh that is not the
    # world, a backend that cannot carry the device's tensors (the 2-D
    # mesh: tests/test_torch_parallel_2d.py)
    refused = {}
    other = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
    checks = {
        "train_model_axis": lambda: tt.train(tr["cfg"], mesh=other,
                                             device="cpu"),
        "mesh_3": lambda: pm.make_mesh(3, device="cpu"),
        "mesh_1": lambda: pm.make_mesh(1, device="cpu"),
        "mesh_cuda": lambda: pm.make_mesh(device="cuda")}
    for name, fn in checks.items():
        try:
            fn()
            refused[name] = None
        except Exception as e:  # the test reads the type and message
            refused[name] = (type(e).__name__, str(e))
    out["refused"] = refused
    return out


# ------------------------------------------------------------------ fixtures


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step_inputs():
    """tests/test_parallel_mesh.py's tiny model and batch, made by the
    port: a seeded init at nf 16, pstep 2 (its state_dict) and 8 graphs
    of 20 objects and one tool point (numpy), the futures a target a
    little off the last state."""
    import chip_smoke as cs
    from adaptigraph_torch.dynamics import DynamicsPredictor
    from adaptigraph_torch.dynamics.model import ModelConfig

    model = DynamicsPredictor(ModelConfig(n_his=4, nf=16, pstep=2),
                              device="cpu",
                              generator=torch.Generator().manual_seed(1))
    g, _ = cs.toy_graph_batch("cpu", b=8, n_obj=20, n_eef=1, n_his=4,
                              max_nr=100, seed=0)
    keys = ("state", "attrs", "recv", "send", "edge_valid", "p_instance",
            "physics_param", "action", "obj_mask")
    batch = {k: g[k].numpy() for k in keys}
    last = batch["state"][:, -1, :20]
    batch["state_future"] = np.repeat(last[:, None], 3, 1) + np.float32(0.01)
    batch["eef_future"] = np.zeros((8, 2, 21, 3), np.float32)
    batch["action_future"] = np.zeros((8, 2, 21, 3), np.float32)
    return {"params": dict(model.state_dict()), "batch": batch}


def _jax_step(step):
    """One JAX make_train_step under make_mesh(2) from the port's params
    (params_to_jax) on the same batch: (params after, carried back by
    params_from_jax; the loss)."""
    import jax
    import jax.numpy as jnp
    import optax

    from adaptigraph_tpu.dynamics.model import DynamicsPredictor as JModel
    from adaptigraph_tpu.dynamics.model import ModelConfig as JConfig
    from adaptigraph_tpu.dynamics.train import make_train_step
    from adaptigraph_tpu.parallel.mesh import (make_mesh, replicate,
                                               shard_batch)
    from adaptigraph_torch.dynamics.model import (ModelConfig,
                                                  params_from_jax,
                                                  params_to_jax)

    tcfg = ModelConfig(n_his=4, nf=16, pstep=2)
    params = jax.tree.map(jnp.asarray, params_to_jax(step["params"], tcfg))
    batch = {k: jnp.asarray(v) for k, v in step["batch"].items()}
    opt = optax.adam(1e-3)
    train_step, _ = make_train_step(JModel(JConfig(n_his=4, nf=16,
                                                   pstep=2)), 3, opt)
    mesh = make_mesh(2)
    after, _, loss = train_step(replicate(params, mesh),
                                replicate(opt.init(params), mesh),
                                shard_batch(batch, mesh))
    return params_from_jax(jax.tree.map(np.asarray, after), tcfg), float(loss)


def _jax_planner(kind, key_seed=0):
    """JAX's Planner over make_mesh(2) on the toy model: its act_seq."""
    import jax
    import jax.numpy as jnp

    from adaptigraph_tpu.parallel.mesh import make_mesh
    from adaptigraph_tpu.planning.actions import decode_action as jdecode
    from adaptigraph_tpu.planning.planner import Planner as JPlanner

    target = jnp.array(TARGET)

    def model_rollout(state_cur, act_seqs):
        dec, _ = jdecode(act_seqs, push_length=0.2)
        end = dec[..., 2:]
        states = jnp.concatenate([end, jnp.zeros_like(end[..., :1])], -1)
        return {"state_seqs": states[:, :, None, :]}

    def evaluate(state_seqs, act_seqs, state_cur=None, **kw):
        d = jnp.linalg.norm(state_seqs[:, -1, 0, :2] - target, axis=-1)
        return {"reward_seqs": -d / d.max() if kind == "GD" else -d}

    cfg = {"action_dim": 4, "model_rollout_fn": model_rollout,
           "evaluate_traj_fn": evaluate, "n_sample": N_SAMPLE,
           "n_look_ahead": 1, "n_update_iter": 2 if kind == "MPPI" else 3,
           "reward_weight": 50.0, "action_lower_lim": LOWER,
           "action_upper_lim": UPPER, "planner_type": kind,
           "noise_level": 0.5, "push_length": 0.2, "lr": 0.05,
           "mesh": make_mesh(2)}
    res = JPlanner(cfg).trajectory_optimization(
        jnp.zeros((1, 3)), jnp.asarray(ACT0), key=jax.random.PRNGKey(key_seed))
    return np.asarray(res["act_seq"])


def _jax_draws():
    """JAX's Planner draws from PRNGKey(0): MPPI's two iterations (one
    split an iteration) and GD's one uniform block (the key unsplit)."""
    import jax

    from tests.test_torch_plan import _key_draws

    draw = _key_draws(jax.random.PRNGKey(0))
    mppi = [draw(i, N_SAMPLE, 1, 4).numpy() for i in range(2)]
    gd = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                       (N_SAMPLE, 1, 4)))
    return {"MPPI": mppi, "GD": [gd]}


def _frames():
    """tests/test_torch_loop.py's frames: the port's SimPlanEnv on the tiny
    block, settled and then moved by each of MOVES."""
    import adaptigraph_torch.planning.plan as tplan
    from tests.test_torch_plan import MOVES, OBS, SEED
    from tests.test_torch_sim import patch_tiny

    with pytest.MonkeyPatch.context() as patch:
        patch_tiny(patch)
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
        return frames, te.cam_intr, te.cam_extr


def _one_process(inputs, tmp):
    """What one process computes from the ranks' inputs: JAX's references
    and the port without a mesh (train(), the Planner, plan())."""
    from adaptigraph_torch.planning import Planner

    refs = {"jax_step": _jax_step(inputs["step"]),
            "jax_planner": {k: _jax_planner(k) for k in ("MPPI", "GD")}}
    tr = inputs["train"]
    refs["train"] = {}
    for name, over in TRAIN_RUNS:
        out = tmp / f"one_{name}"
        cfg = tr["cfg"].override({"train_config": dict(out_dir=str(out),
                                                       **over)})
        params, hist = tt.train(cfg, device="cpu",
                                steps_per_call=2 if name == "split" else None)
        refs["train"][name] = {"params": params, "history": hist,
                               "files": sorted(os.listdir(out / "rope"))}
    refs["planner"] = {}
    for kind in ("MPPI", "GD"):
        seen = []
        act = Planner(planner_config(kind, inputs["draws"][kind], seen=seen)
                      ).trajectory_optimization(torch.zeros((1, 3)), ACT0,
                                                seed=0)["act_seq"]
        refs["planner"][kind] = {"act_seq": act.numpy(), "seen": seen}
    pl = inputs["plan"]
    env = FramesEnv(pl["frames"], pl["intr"], pl["extr"])
    stats = run_plan(pl, tmp / "plan_one", env)
    refs["plan"] = {"stats": stats, "actions": env.actions,
                    "files": sorted(os.listdir(tmp / "plan_one"))}
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs of every case, the ranks' results and one process's:
    {'inputs', 'ranks', 'one'}. The ranks run while this process computes
    its own."""
    from adaptigraph_torch.dynamics import DynamicsPredictor
    from adaptigraph_torch.dynamics.model import model_config_from_yaml
    from tests.test_torch_plan import _task

    tmp = tmp_path_factory.mktemp("parallel")
    tree = {"div": np.arange(24, dtype=np.float32).reshape(8, 3),
            "odd": np.arange(5, dtype=np.int32),
            "zero": np.array(3.0, np.float32),
            "nested": [np.arange(8, dtype=np.float32).reshape(4, 2)]}
    dyn = load_config("dynamics/rope")
    rope_cfg = model_config_from_yaml(dyn["model_config"],
                                      dyn["dataset_config"], 1)
    rope = DynamicsPredictor(rope_cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    frames, intr, extr = _frames()
    (tmp / "data").mkdir()
    inputs = {
        "tree": tree, "step": _step_inputs(),
        "train": {"cfg": write_episodes(tmp / "data"), "root": str(tmp)},
        "draws": _jax_draws(),
        "plan": {"task": _task(target_type="box",
                               target=[-0.05, 0.05, -0.05, 0.05]),
                 "params": dict(rope.state_dict()), "frames": frames,
                 "intr": intr, "extr": extr, "root": str(tmp)}}
    started = start(_cases, inputs, tmp)
    try:
        one = _one_process(inputs, tmp)
    finally:
        ranks = finish(started, tmp)
    return {"inputs": inputs, "ranks": ranks, "one": one}


# -------------------------------------------------------------------- tests


def test_make_mesh_spans_the_world(world):
    for r, out in enumerate(world["ranks"]):
        assert out["mesh"] == (WORLD, "cpu", ("data",), r)


def test_shard_batch_equals_jax_shards(world):
    """Rank r's leaves are JAX's addressable_shards[r] under make_mesh(2):
    rows of the divisible leaves, the others whole (the 0-d leaf too)."""
    from adaptigraph_tpu.parallel.mesh import make_mesh, shard_batch

    tree = world["inputs"]["tree"]
    jmesh = make_mesh(2)
    flat = dict(tree, nested=tree["nested"][0])
    sharded = shard_batch(flat, jmesh)
    for r, out in enumerate(world["ranks"]):
        got = dict(out["shard"], nested=out["shard"]["nested"][0])
        for k, x in sharded.items():
            dev = jmesh.devices.flat[r]
            shard = next(s for s in x.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(got[k], np.asarray(shard.data))
    assert world["ranks"][1]["shard"]["div"].tolist() == \
        tree["div"][4:].tolist()
    assert world["ranks"][1]["shard"]["odd"].tolist() == list(range(5))


def test_replicate_gives_every_rank_rank_0s_leaves(world):
    for r, out in enumerate(world["ranks"]):
        rep, own = out["replicate"]
        assert torch.equal(rep["t"], torch.ones(3))
        np.testing.assert_array_equal(rep["a"], np.zeros(2, np.int32))
        assert rep["a"].dtype == np.int32 and rep["o"] == {"r": 0}
        assert rep["b"].tolist() == [True]
        assert torch.equal(own, torch.full((3,), float(r + 1)))  # untouched


def test_data_parallel_step_equals_jax_under_make_mesh_2(world):
    """Each rank steps on its 4 of the 8 graphs; the mean gradient and
    Adam then match JAX's sharded train step."""
    want, loss = world["one"]["jax_step"]
    r0, r1 = (out["step"] for out in world["ranks"])
    assert r0["rows"] == r1["rows"] == 4
    # the loss is ~116 (random weights), where float32's spacing is 7.6e-6
    assert abs(r0["loss"] - loss) <= 1e-6 * abs(loss)
    assert r0["loss"] == r1["loss"]
    for k, v in want.items():
        np.testing.assert_allclose(r0["params"][k].numpy(), np.asarray(v),
                                   atol=1e-6, err_msg=k)
        assert torch.equal(r0["params"][k], r1["params"][k]), k
    moved = max(float((r0["params"][k] - world["inputs"]["step"]["params"][k])
                      .abs().max()) for k in want)
    assert moved > 1e-4  # Adam really stepped


@pytest.mark.parametrize("name", [n for n, _ in TRAIN_RUNS])
def test_train_on_two_ranks_equals_one_process(world, name):
    """train() on the mesh of two ranks (taken from the world) against one
    process on the same config, indices and draws: B 8 split 4 + 4 through
    2-step chunks; B 7, which the mesh does not divide, whole on both
    ranks through the host loop. Only rank 0 wrote files."""
    one = world["one"]["train"][name]
    r0, r1 = (out["train"][name] for out in world["ranks"])
    assert r0["history"] == r1["history"]
    for phase in ("train", "valid"):
        np.testing.assert_allclose(r0["history"][phase],
                                   one["history"][phase], rtol=1e-5)
    for k, v in one["params"].items():
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        np.testing.assert_allclose(r0["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
        if name == "whole":  # nothing averaged: the same arithmetic
            assert torch.equal(r0["params"][k], v), k
    assert not r1["made"] and r1["files"] is None
    assert "train_state.json" in r0["files"]
    assert r0["files"] == one["files"]


@pytest.mark.parametrize("kind", ["MPPI", "GD"])
def test_planner_splits_the_population(world, kind):
    """Each rank rolled out 128 of the 256 samples (GD's final choice and
    each step too); act_seq within 1e-5 of the meshless port run and of
    JAX's Planner over make_mesh(2), JAX's draws replayed; the ranks
    equal. GD's reward reads every row (the population's largest
    distance), so its gradient crosses the ranks."""
    one = world["one"]["planner"][kind]
    r0, r1 = (out["planner"][kind] for out in world["ranks"])
    np.testing.assert_array_equal(r0["act_seq"], r1["act_seq"])
    np.testing.assert_allclose(r0["act_seq"], one["act_seq"], atol=1e-5)
    np.testing.assert_allclose(r0["act_seq"],
                               world["one"]["jax_planner"][kind], atol=1e-5)
    iters = 2 if kind == "MPPI" else 3 + 1
    assert r0["seen"] == [N_SAMPLE // WORLD] * iters + [1]
    assert one["seen"] == [N_SAMPLE] * iters + [1]
    if kind == "MPPI":
        assert r0["verbose_rows"] == [(N_SAMPLE, N_SAMPLE)] * 2


def test_planner_mesh_rule(world):
    """plan.py's _planner_mesh: the world's mesh when its size divides the
    population, None otherwise and without a process group."""
    from adaptigraph_torch.planning.plan import _planner_mesh

    for out in world["ranks"]:
        assert out["planner_mesh"] == [WORLD, None]
    assert _planner_mesh(PLAN_SAMPLES, "cpu") is None


def test_plan_on_two_ranks_chooses_one_processs_push(world):
    """plan() on two ranks (one action, 2 iterations, 64 samples, 32 a
    rank): rank 0 alone perceives, pushes and writes the artefacts, and
    its push is one process's within 1e-5; both ranks return its stats."""
    one = world["one"]["plan"]
    r0, r1 = (out["plan"] for out in world["ranks"])
    assert r1["actions"] is None and r1["files"] is None
    assert len(r0["actions"]) == len(one["actions"]) == 1
    np.testing.assert_allclose(r0["actions"][0], one["actions"][0],
                               atol=1e-5)
    assert r0["stats"] == r1["stats"]
    np.testing.assert_allclose(np.asarray(r0["stats"]),
                               np.asarray(one["stats"]), atol=1e-5)
    assert "interaction_000.npz" in r0["files"] and "stats.txt" in r0["files"]
    assert r0["files"] == one["files"]


def test_a_2d_mesh_and_other_meshes_raise(world):
    """A 1-D mesh named otherwise raises NotImplementedError naming the
    port's layouts; a mesh that is not the world raises ValueError; gloo
    cannot carry CUDA tensors, and make_mesh says so instead of falling
    back. The 2-D mesh runs: tests/test_torch_parallel_2d.py."""
    for out in world["ranks"]:
        ref = out["refused"]
        kind, msg = ref["train_model_axis"]
        assert kind == "NotImplementedError", ref["train_model_axis"]
        assert "make_mesh_2d" in msg and "data axis first" in msg
        for name in ("mesh_3", "mesh_1"):
            assert ref[name][0] == "ValueError", ref[name]
        assert ref["mesh_cuda"][0] == "RuntimeError"
        assert "does not carry cuda" in ref["mesh_cuda"][1]


def test_make_mesh_needs_a_process_group(monkeypatch):
    """Without a process group make_mesh raises and says how to start one;
    init_from_env starts none outside torchrun (WORLD_SIZE unset or 1)."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        pm.make_mesh(device="cpu")
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", env)
        pm.init_from_env("cpu")
        assert not dist.is_initialized() and pm.world_size() == 1


def test_smoke_mesh_path_runs_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's mesh phases, rehearsed with the CPU in the card's
    place at world size 1 over gloo (the profiler replaced by a host
    clock): train() with the mesh equals train() without it bit for bit,
    a toy Planner with the mesh equals it without, the 2-D layout at
    (1, 1) (every layer column-parallel) equals the steps and train()
    without a mesh bit for bit, the tiled neighbor list the dense one; no
    contact kernel; the group destroyed after."""
    import json

    import chip_smoke as cs
    from adaptigraph_torch.planning import Planner
    from adaptigraph_torch.tools import profile_frame

    def host_profile(fn, frames):
        t0 = time.perf_counter()
        fn()
        return {"wall_ms_per_frame": 1e3 * (time.perf_counter() - t0) / frames,
                "device_busy_ms_per_frame": 0.0, "device_idle_share": 1.0,
                "kernel_launches_per_frame": 0.0, "top_kernels": []}

    monkeypatch.setattr(profile_frame, "profiled", host_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "MESH_BACKEND", "gloo")
    monkeypatch.setattr(cs, "TRAIN_K", 2)
    monkeypatch.setattr(cs, "MESH_TILE", 64)
    lines = []
    monkeypatch.setattr(cs, "emit",
                        lambda r: lines.append(json.loads(json.dumps(r))))
    (tmp_path / "data").mkdir()
    dyn = write_episodes(tmp_path / "data")
    draws = [np.random.RandomState(i).rand(N_SAMPLE, 1, 4).astype(np.float32)
             if i == 0 else np.random.RandomState(i).randn(1, N_SAMPLE, 4)
             .astype(np.float32) for i in range(2)]

    def run(mesh):
        return Planner(planner_config("MPPI", draws, mesh)
                       ).trajectory_optimization(torch.zeros((1, 3)), ACT0,
                                                 seed=0)["act_seq"]

    want = run(None)
    pos = torch.from_numpy(np.random.RandomState(0).rand(203, 3)
                           .astype(np.float32))
    active = torch.ones(203, dtype=torch.bool)
    out = cs.mesh_phases("cpu", dyn, str(tmp_path),
                         lambda mesh: (run(mesh), want), (pos, active, 0.15),
                         batch=8)
    assert [ln["phase"] for ln in lines] == [
        "mesh_init", "mesh_train", "mesh_train_times", "mesh_plan",
        "mesh_2d", "mesh_neighbors"]
    assert all(ln["ok"] for ln in lines)
    assert lines[0]["backend"] == "gloo" and lines[0]["mesh_size"] == 1
    assert lines[1]["params_equal"] and lines[3]["act_seq_equal"]
    two = lines[4]
    assert two["column_parallel_layers"] == two["layers"] == 11
    assert two["steps_equal"] and two["train_equal"]
    assert two["steps_params_max_abs_diff"] == 0.0
    assert set(two["profiled"]) == {"plain", "layout"}
    assert lines[5]["idx_equal"] and lines[5]["neighbors"] > 0
    assert not any(out["counts"].values())
    assert not dist.is_initialized()
