"""Port parity: the rollout evaluator and its host side (frame pairing,
the dataset's loaders, the property params) against the JAX package, on
restored compact rope episodes with the rope checkpoint carried across by
params_from_jax.

Four compact rope episodes (data/compact/rope/000000-000003) are copied
into a temporary directory and preprocessed there by JAX's preprocess;
nothing is written under data/. Tolerances (measured maxima from one run on
the CPU beside each):
- frame pairs, the dataset's arrays, FPS indices, start graphs and every
  step's edge list: exact;
- one rollout step's prediction: 1e-5 (2.4e-7);
- the evaluators end to end (RandomState(42), up to 20 steps a push, the
  pair walk chained across pushes; 93 steps over the validation episode's
  five pushes): per-step errors within 1e-5 (2.4e-7), edges equal at every
  step.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.dynamics import preprocess as jpre
from adaptigraph_tpu.dynamics import rollout as jroll
from adaptigraph_tpu.dynamics.dataset import DynDataset as JDataset
from adaptigraph_tpu.dynamics.train import init_model as j_init_model
from adaptigraph_tpu.dynamics.train import load_checkpoint
from adaptigraph_tpu.sim import episode_io as jio
from adaptigraph_tpu.utils import load_config as j_load_config
from adaptigraph_torch.dynamics import preprocess as tpre
from adaptigraph_torch.dynamics import rollout as troll
from adaptigraph_torch.dynamics.dataset import DynDataset as TDataset
from adaptigraph_torch.dynamics.model import params_from_jax
from adaptigraph_torch.dynamics.train import init_model as t_init_model
from adaptigraph_torch.sim import episode_io as tio
from adaptigraph_torch.utils import load_config as t_load_config

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ATOL = 1e-5
_STEPS = 20
_EPISODES = ("000000", "000001", "000002", "000003")


@pytest.fixture(scope="module")
def rope(tmp_path_factory):
    """(JAX config, port config, JAX params, port state_dict) over four
    restored and preprocessed compact rope episodes."""
    tmp = tmp_path_factory.mktemp("rope")
    for name in _EPISODES:
        shutil.copytree(os.path.join(_ROOT, "data", "compact", "rope", name),
                        tmp / "sim_data" / "rope" / name)
    over = {"dataset_config": {"data_dir": str(tmp / "sim_data"),
                               "prep_data_dir": str(tmp / "preprocess")},
            "train_config": {"out_dir": os.path.join(_ROOT, "data", "log")}}
    jcfg = j_load_config("dynamics/rope").override(
        over, rollout_config={"out_dir": str(tmp / "jax_rollout")})
    tcfg = t_load_config("dynamics/rope").override(
        over, rollout_config={"out_dir": str(tmp / "port_rollout")})
    jpre.preprocess(jcfg)
    dataset = JDataset(jcfg["dataset_config"], jcfg["material_config"],
                       "valid")
    model, params0 = j_init_model(jcfg, dataset)
    ckpt = os.path.join(_ROOT, "data", "log", "rope", "checkpoints")
    jparams = load_checkpoint(ckpt, "latest", params0)
    tmodel, _ = t_init_model(tcfg, dataset, device="cpu")
    sd = params_from_jax(jax.tree.map(np.asarray, jparams), tmodel.cfg)
    tmodel.load_state_dict(sd, strict=True)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=model, jparams=jparams,
                tmodel=tmodel, sd=sd, dataset=dataset)


def _pair_table(n_his=4):
    rows = [list(range(s, s + n_his + 1)) for s in range(0, 6)]
    rows += [list(range(s, s + n_his + 1)) for s in range(14, 19)]
    return np.asarray(rows, int)


@pytest.mark.parametrize("scan", [False, True])
def test_get_next_pair_equals_jax(scan):
    """tests/test_dynamics.py's tables: the walk to each push's end and,
    with the scan, across the gap into the next push and past the last
    frame."""
    pairs = _pair_table()
    for end in list(pairs[:, 4]) + [9, 10, 12, 13, 22, 23, 29]:
        j = jroll.get_next_pair(pairs, 4, end, n_frames=30, scan=scan)
        t = troll.get_next_pair(pairs, 4, end, n_frames=30, scan=scan)
        assert (j is None and t is None) or np.array_equal(j, t)
    end, walked = pairs[0][4], []
    while (nxt := troll.get_next_pair(pairs, 4, end, n_frames=30,
                                      scan=scan)) is not None:
        end = nxt[4]
        walked.append(end)
    assert len(walked) == (10 if scan else 5)


def test_preprocess_helpers_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    eef = np.cumsum(rng.rand(30, 1, 3) * 0.04, axis=0)
    for thresh in (0.05, 0.09):
        j = jpre.extract_push(eef, thresh, 4, 3, 11)
        t = tpre.extract_push(eef, thresh, 4, 3, 11)
        assert np.array_equal(j[0], t[0]) and j[1] == t[1]
    states = rng.rand(5, 2, 14)
    states[..., 6:10] /= np.linalg.norm(states[..., 6:10], axis=-1,
                                        keepdims=True)
    eef_cfg = {"max_neef": 5, "pos": rng.rand(5, 3).tolist()}
    assert np.array_equal(jpre.process_eef(states, eef_cfg),
                          tpre.process_eef(states, eef_cfg))
    pos = rng.rand(6, 8, 3).astype(np.float32)
    pos[2, 3] = 50.0
    pos[:, 5] = -40.0
    assert np.array_equal(jpre.sanitize_positions(pos),
                          tpre.sanitize_positions(pos))
    props = {"stiffness": 0.25, "length": 3.0}
    tio.save_property_params(str(tmp_path), props)
    assert jio.load_property_params(str(tmp_path)) == props
    assert tio.load_property_params(str(tmp_path)) == props
    np.testing.assert_array_equal(tpre.extract_physics(str(tmp_path), "rope"),
                                  jpre.extract_physics(str(tmp_path), "rope"))


def test_dataset_equals_jax(rope):
    jcfg, tcfg = rope["jcfg"], rope["tcfg"]
    for phase in ("train", "valid"):
        j = JDataset(jcfg["dataset_config"], jcfg["material_config"], phase)
        t = TDataset(tcfg["dataset_config"], tcfg["material_config"], phase)
        assert np.array_equal(j.pair_lists, t.pair_lists) and len(t) > 0
        assert (j.n_raw, j.n_eef, j.phys_dim) == (t.n_raw, t.n_eef,
                                                  t.phys_dim)
        idx = np.arange(0, len(t), max(1, len(t) // 7))
        jb, tb = j.raw_batch(idx), t.raw_batch(idx)
        for k in jb:
            assert np.array_equal(jb[k], tb[k]), k


def _episode(rope):
    ds = rope["dataset"]
    return ds.eef_pos[0], ds.obj_pos[0], ds.physics_params[0]["rope"]


@pytest.mark.parametrize("slotted", [False, True])
def test_construct_graph_equals_jax(rope, slotted):
    eef, obj, phys = _episode(rope)
    dcfg = rope["tcfg"]["dataset_config"]
    pair = np.array([0, 4, 8, 12, 16, 17, 18])
    jg, jidx = jroll.construct_graph(dcfg, eef, obj, 4, pair, phys,
                                     np.random.RandomState(5),
                                     slotted=slotted)
    tg, tidx = troll.construct_graph(dcfg, eef, obj, 4, pair, phys,
                                     np.random.RandomState(5),
                                     slotted=slotted, device="cpu")
    assert np.array_equal(jidx, tidx) and 10 < len(tidx) <= 100
    assert sorted(jg) == sorted(tg)
    for k in jg:
        assert np.array_equal(np.asarray(jg[k]), tg[k].numpy()), k
        assert np.asarray(jg[k]).dtype == tg[k].numpy().dtype, k


def test_one_rollout_step_equals_jax(rope):
    eef, obj, phys = _episode(rope)
    dcfg = rope["tcfg"]["dataset_config"]
    pair = np.array([0, 4, 8, 12, 16, 17, 18])
    jg, _ = jroll.construct_graph(dcfg, eef, obj, 4, pair, phys,
                                  np.random.RandomState(5))
    tg, _ = troll.construct_graph(dcfg, eef, obj, 4, pair, phys,
                                  np.random.RandomState(5), device="cpu")
    j_step = jroll.make_rollout_step(rope["jmodel"], dcfg)
    t_step = troll.make_rollout_step(rope["tmodel"], dcfg)
    a, b = eef[12].astype(np.float32), eef[16].astype(np.float32)
    jp, jg2 = j_step(rope["jparams"], jg, jnp.asarray(a), jnp.asarray(b))
    tp, tg2 = t_step(rope["sd"], tg, torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=_ATOL)
    for k in ("recv", "send", "edge_valid"):
        assert np.array_equal(tg2[k].numpy(), np.asarray(jg2[k])), k
    np.testing.assert_allclose(tg2["state"].numpy(), np.asarray(jg2["state"]),
                               rtol=0, atol=_ATOL)
    assert np.array_equal(tg2["action"].numpy(), np.asarray(jg2["action"]))


def _recording(step_fn, edges):
    def step(params, graph, eef_start, eef_end):
        pred, graph = step_fn(params, graph, eef_start, eef_end)
        edges.append(tuple(np.asarray(graph[k]) for k in
                           ("recv", "send", "edge_valid")))
        return pred, graph
    return step


def test_rollout_end_to_end_equals_jax(rope):
    """Both evaluators over the validation episode's pushes, with
    RandomState(42) as rollout.py draws it: the pushes' error curves, and
    the edge lists of every step, from the same push loop with each side's
    step."""
    jcfg, tcfg = rope["jcfg"], rope["tcfg"]
    j_err = jroll.rollout(jcfg, rollout_steps=_STEPS)
    t_err = troll.rollout(tcfg, rope["sd"], rollout_steps=_STEPS,
                          device="cpu")
    assert len(j_err) == len(t_err) >= 4
    assert max(len(e) for e in t_err) == _STEPS
    for je, te in zip(j_err, t_err):
        assert len(je) == len(te) > 1
        np.testing.assert_allclose(te, je, rtol=0, atol=_ATOL)
    assert os.path.exists(os.path.join(tcfg["rollout_config"]["out_dir"],
                                       "rope", "error_median.txt"))

    ds = rope["dataset"]
    dcfg = tcfg["dataset_config"]
    prep = os.path.join(dcfg["prep_data_dir"], "rope", "frame_pairs")
    epi = ds.pair_lists[0][0]
    tables = [np.atleast_2d(np.loadtxt(os.path.join(prep, f)).astype(int))
              for f in sorted(os.listdir(prep))
              if f.startswith(_EPISODES[epi])]
    pairs_all = np.vstack(tables)
    eef, obj = ds.eef_pos[epi], ds.obj_pos[epi]
    phys = ds.physics_params[epi]["rope"]
    j_rng, t_rng = np.random.RandomState(42), np.random.RandomState(42)
    j_edges, t_edges, n_steps = [], [], 0
    j_step = _recording(jroll.make_rollout_step(rope["jmodel"], dcfg),
                        j_edges)
    t_step = _recording(troll.make_rollout_step(rope["tmodel"], dcfg),
                        t_edges)
    for pairs in tables:
        pair = pairs[0]
        jg, jidx = jroll.construct_graph(dcfg, eef, obj, 4, pair, phys, j_rng)
        tg, tidx = troll.construct_graph(dcfg, eef, obj, 4, pair, phys, t_rng,
                                         device="cpu")
        assert np.array_equal(jidx, tidx)
        args = (pairs_all, eef, obj, 4, pair[3], pair[4], 100, _STEPS)
        je = jroll.rollout_push(rope["jparams"], j_step, jg, jidx, *args,
                                scan=True)
        te = troll.rollout_push(rope["sd"], t_step, tg, tidx, *args,
                                scan=True)
        np.testing.assert_allclose(te, je, rtol=0, atol=_ATOL)
        n_steps += len(te)
    assert len(j_edges) == len(t_edges) == n_steps
    for step, (a, b) in enumerate(zip(j_edges, t_edges)):
        for x, y in zip(a, b):
            assert np.array_equal(x, y), step


def test_rollout_entry_points_raise_without_a_device(rope, monkeypatch,
                                                     tmp_path):
    eef, obj, phys = _episode(rope)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        troll.construct_graph(rope["tcfg"]["dataset_config"], eef, obj, 4,
                              np.array([0, 4, 8, 12, 16, 17, 18]), phys,
                              np.random.RandomState(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        troll.rollout(rope["tcfg"], rope["sd"], rollout_steps=1)
    # viz is ported: the restored compact episodes hold no frames and no
    # cameras, so it rolls on and draws nothing
    cfg = rope["tcfg"].override({}, rollout_config={"out_dir": str(tmp_path)})
    errs = troll.rollout(cfg, rope["sd"], viz=True, rollout_steps=1,
                         max_episodes=1, device="cpu")
    assert errs and all(len(e) == 1 for e in errs)
    assert not any(f.startswith("viz_")
                   for f in os.listdir(tmp_path / "rope"))


def test_smoke_gnn_path_runs_on_the_cpu(rope, monkeypatch):
    """chip_smoke.py's learned-step phases, rehearsed with the CPU in the
    card's place (its CUDA timers and the profiler replaced by host
    clocks) over an episode of the restored rope data: every gate holds,
    as card and CPU are then one device."""
    import time

    import chip_smoke as cs
    from adaptigraph_torch.tools import profile_frame

    def host_ms(fn, reps, warm=1):
        for _ in range(warm):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps

    def host_profile(fn, steps):
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
        return {"wall_ms_per_frame": 1e3 * wall / steps,
                "device_busy_ms_per_frame": 0.0, "device_idle_share": 1.0,
                "kernel_launches_per_frame": 0.0, "top_kernels": [],
                "profile": None}

    monkeypatch.setattr(cs, "event_ms", lambda fn, reps: host_ms(fn, 2))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profile_frame, "profiled", host_profile)
    ds = rope["dataset"]
    out = cs.gnn_phases("cpu", ds.obj_pos[1], ds.eef_pos[1])
    assert out["graph_steps_per_s"] > 0 and out["launches_per_step"] == 0
