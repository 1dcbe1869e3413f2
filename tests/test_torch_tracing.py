"""The port's tracer (adaptigraph_torch.utils.profiling) on a tiny planning
call and a tiny train chunk: off it records nothing and changes nothing,
on its spans nest as the layers call each other and its counters equal
counts made independently; trace(dir) writes the spans beside the
profiler's own events."""

from __future__ import annotations

import json
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from adaptigraph_torch.dynamics.model import DynamicsPredictor, ModelConfig
from adaptigraph_torch.dynamics.train import make_optimizer, make_train_chunk
from adaptigraph_torch.planning import forward_dynamics as fd
from adaptigraph_torch.planning.planner import Planner
from adaptigraph_torch.utils import profiling

N_ITER, N_SAMPLE, CHUNK, N_LOOK, MAX_REPEAT, PSTEP = 2, 10, 4, 2, 3, 2
K, N_FUTURE = 3, 2


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """One torch thread (test workers share the cores), and the tracer off
    and empty before and after every test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()
    torch.set_num_threads(n)


def _model(n_his):
    return DynamicsPredictor(ModelConfig(n_his=n_his, nf=16, pstep=PSTEP),
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))


def _plan(on: bool):
    """One MPPI call: N_ITER iterations of N_SAMPLE pushes in chunks of
    CHUNK (the last chunk padded), N_LOOK steps of 1-3 repeats. Returns
    (the planner's result, every population the evaluator scored)."""
    model = _model(4).eval()
    params = dict(model.state_dict())
    task = {"pusher_points": [[0.0, 0.0, 0.1]], "sim_real_ratio": 10,
            "push_length": 0.2, "adj_thresh": 0.5, "topk": 5,
            "connect_tools_all": False, "n_his": 4, "gripper_enable": False,
            "n_sample_chunk": CHUNK,
            "action_lower_lim": [-4.5, -2.5, -3.14, 1],
            "action_upper_lim": [0.0, 4.5, 3.14, MAX_REPEAT]}
    rollout = fd.make_batched_dynamics(model, task)
    g = torch.Generator().manual_seed(3)
    state = torch.rand(20, 3, generator=g)
    mask = torch.ones(20, dtype=torch.bool)
    mask[-4:] = False
    target = torch.rand(20, 3, generator=g)
    phys = torch.tensor([0.5])
    pops = []

    def evaluate(state_seqs, acts, state_cur=None):
        pops.append(acts.clone())
        err = (state_seqs[:, -1] - target).pow(2).sum(-1)
        return {"reward_seqs": -(err * mask).sum(-1)}

    planner = Planner({
        "action_dim": 4, "evaluate_traj_fn": evaluate,
        "model_rollout_fn": lambda s, a: rollout(params, state, mask, a,
                                                 phys),
        "n_sample": N_SAMPLE, "n_look_ahead": N_LOOK,
        "n_update_iter": N_ITER, "reward_weight": 10.0,
        "action_lower_lim": np.array(task["action_lower_lim"], np.float32),
        "action_upper_lim": np.array(task["action_upper_lim"], np.float32),
        "planner_type": "MPPI", "noise_level": 0.5, "push_length": 0.2,
        "device": "cpu"})
    init = np.tile(np.array([[-1.0, 0.0, 0.0, 2.0]], np.float32), (N_LOOK, 1))
    if on:
        profiling.enable()
    try:
        res = planner.trajectory_optimization(state, init, seed=5)
    finally:
        profiling.disable()
    return res, pops


def _train(on: bool):
    """One K-step chunk at B 4 over two random 12-frame episodes, with
    augmentation (state noise and rotation drawn). Returns (the K losses,
    the parameters after it)."""
    n_his, t, n_raw = 2, 12, 60
    ds = SimpleNamespace(n_his=n_his, n_future=N_FUTURE, max_nobj=10,
                         max_nR=80, topk=3, connect_tool_all=False,
                         fps_radius_range=(0.1, 0.15),
                         adj_radius_range=(0.3, 0.35), augment=True,
                         state_noise=0.01, phys_noise=0.0)
    g = torch.Generator().manual_seed(7)
    common = {"obj": torch.rand(2, t, n_raw, 3, generator=g),
              "eef": torch.rand(2, t, 1, 3, generator=g),
              "nobj": torch.tensor([n_raw, n_raw - 10], dtype=torch.int32),
              "phys": torch.full((2, 1), 0.5)}
    starts = torch.arange(t - n_his - N_FUTURE + 1)
    frames = starts[:, None] + torch.arange(n_his + N_FUTURE)
    pairs = torch.cat([torch.arange(2).repeat_interleave(len(starts))[:, None],
                       frames.repeat(2, 1)], 1).to(torch.int32)
    model = _model(n_his)
    opt, _ = make_optimizer(model.parameters(), 1e-3)
    chunk, _ = make_train_chunk(model, N_FUTURE, opt, ds, common, pairs,
                                torch.Generator().manual_seed(11))
    idx = np.random.default_rng(0).integers(0, len(pairs), (K, 4))
    if on:
        profiling.enable()
    try:
        losses = chunk(idx)
    finally:
        profiling.disable()
    return losses, {k: v.detach().clone() for k, v in model.state_dict()
                    .items()}


def _tree(spans):
    """Every span's parent and root are spans of the export, a parent
    opens before its child and closes after it, and a root is its own."""
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is None:
            assert s["root"] == s["id"]
        else:
            p = by_id[s["parent"]]
            assert s["root"] == p["root"]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    return by_id


def test_off_records_nothing_and_changes_nothing():
    """The planning call and the train chunk give bit-identical outputs
    with the tracer off and on; off, nothing is stored and span() is one
    shared object."""
    off_res, _ = _plan(False)
    off_losses, off_params = _train(False)
    empty = profiling.export()
    assert empty["spans"] == [] and empty["counters"] == {}
    assert profiling.span("a") is profiling.span("b", 3)
    with profiling.span("a"):
        profiling.count("c", torch.ones(3))
    assert profiling.export()["spans"] == []

    on_res, _ = _plan(True)
    on_losses, on_params = _train(True)
    assert profiling.export()["spans"]
    assert torch.equal(off_res["act_seq"], on_res["act_seq"])
    for key in ("best_model_output", "best_eval_output"):
        for k, v in off_res[key].items():
            assert torch.equal(v, on_res[key][k]), (key, k)
    assert torch.equal(off_losses, on_losses)
    assert all(torch.equal(off_params[k], on_params[k]) for k in off_params)


def test_planning_spans_and_counters(monkeypatch):
    """Span counts follow iterations x chunks x look-ahead steps x
    repeats; the counters equal the repeats decoded from the scored
    actions, the edges of direct calls of the slotted edge builder and the
    node rows the mask holds."""
    built = Counter()
    build = fd.build_edges_slotted_batch

    def counted(states, thresh, state_mask, *a, **k):
        e = build(states, thresh, state_mask, *a, **k)
        built["valid"] += int(e.valid.sum())
        built["slots"] += e.valid.numel()
        built["nodes"] += int(state_mask.sum())
        return e
    monkeypatch.setattr(fd, "build_edges_slotted_batch", counted)

    _, pops = _plan(True)
    out = profiling.export()
    spans, c = out["spans"], out["counters"]
    by_id = _tree(spans)
    names = Counter(s["name"] for s in spans)
    chunks = N_ITER * -(-N_SAMPLE // CHUNK) + 1  # and the best push alone
    forwards = chunks * N_LOOK * MAX_REPEAT
    assert names == {"plan.call": 1, "plan.iteration": N_ITER,
                     "plan.score": N_ITER + 1, "rollout.chunk": chunks,
                     "rollout.forward": forwards, "rollout.edges": forwards,
                     "model.incidence": forwards,
                     "model.gather": forwards * (1 + PSTEP),
                     "model.relation_mlp": forwards * (1 + PSTEP),
                     "model.aggregate": forwards * PSTEP}
    call = next(s for s in spans if s["name"] == "plan.call")
    assert all(s["root"] == call["id"] for s in spans)
    parents = {"plan.call": {None}, "plan.iteration": {"plan.call"},
               "plan.score": {"plan.iteration", "plan.call"},
               "rollout.chunk": {"plan.iteration", "plan.call"},
               "rollout.forward": {"rollout.chunk"},
               "rollout.edges": {"rollout.chunk"}}
    for s in spans:
        parent = None if s["parent"] is None else by_id[s["parent"]]["name"]
        assert parent in parents.get(s["name"], {"rollout.forward"}), s
    assert {s["tag"] for s in spans if s["name"] == "rollout.forward"} == {
        CHUNK, 1}

    needed = sum(int(np.trunc(p[..., 3].numpy()).sum()) for p in pops)
    assert [len(p) for p in pops] == [N_SAMPLE] * N_ITER + [1]
    assert c["rollout.sample_forwards_needed"] == needed
    padded = -(-N_SAMPLE // CHUNK) * CHUNK
    assert c["rollout.sample_forwards_run"] == (
        (N_ITER * padded + 1) * N_LOOK * MAX_REPEAT)
    assert c["rollout.valid_edges"] == built["valid"] > 0
    assert c["rollout.edge_slots"] == built["slots"] > built["valid"]
    assert c["rollout.valid_nodes"] == built["nodes"]
    # the rollout runs the 16 object rows the mask holds of 20, and the
    # pusher point, a chunk and look-ahead step
    rows = (N_ITER * padded + 1) * N_LOOK
    assert c["rollout.node_slots_run"] == rows * (16 + 1)
    assert c["rollout.node_slots_full"] == rows * (20 + 1)


def test_train_spans():
    """K steps, each phase once a step under its train.step, prepare.fps
    once a step under train.prepare; no counter in training."""
    _train(True)
    out = profiling.export()
    spans = out["spans"]
    by_id = _tree(spans)
    assert out["counters"] == {}
    names = Counter(s["name"] for s in spans)
    forwards = K * N_FUTURE
    assert names == {"train.chunk": 1, "train.step": K, "train.batch": K,
                     "train.prepare": K, "prepare.fps": K,
                     "prepare.edges": K, "train.forward": K,
                     "train.backward": K, "train.adam": K,
                     "model.incidence": forwards,
                     "model.gather": forwards * (1 + PSTEP),
                     "model.relation_mlp": forwards * (1 + PSTEP),
                     "model.aggregate": forwards * PSTEP}
    parent_of = {"train.step": "train.chunk", "train.batch": "train.step",
                 "train.prepare": "train.step", "prepare.fps": "train.prepare",
                 "prepare.edges": "train.prepare",
                 "train.forward": "train.step", "train.backward": "train.step",
                 "train.adam": "train.step"}
    for s in spans:
        if s["name"] in parent_of:
            assert by_id[s["parent"]]["name"] == parent_of[s["name"]]
        elif s["name"].startswith("model."):
            assert by_id[s["parent"]]["name"] == "train.forward"
    steps = [s["id"] for s in spans if s["name"] == "train.step"]
    fps_steps = [by_id[by_id[s["parent"]]["parent"]]["id"] for s in spans
                 if s["name"] == "prepare.fps"]
    assert sorted(fps_steps) == sorted(steps)
    assert len({s["root"] for s in spans}) == 1


def test_trace_writes_the_span_track(tmp_path):
    """trace(dir): trace.json holds the spans as a track of their own on
    the profiler's clock (a span encloses a profiler range opened inside
    it), and spans.json the export with its anchor."""
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("outer", 2):
            with torch.profiler.record_function("inner"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert not profiling.enabled()
    chrome = json.loads((tmp_path / "t" / "trace.json").read_text())
    events = chrome["traceEvents"]
    outer = [e for e in events if e.get("cat") == "program_span"]
    inner = [e for e in events if e.get("name") == "inner"
             and e.get("cat") != "program_span"]
    assert len(outer) == 1 and outer[0]["name"] == "outer"
    assert outer[0]["args"]["tag"] == 2 and inner
    slack_us = 5e3  # the anchor's two clock reads and the clocks' drift
    assert outer[0]["ts"] - slack_us <= inner[0]["ts"]
    assert (inner[0]["ts"] + inner[0]["dur"]
            <= outer[0]["ts"] + outer[0]["dur"] + slack_us)
    saved = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert [s["name"] for s in saved["spans"]] == ["outer"]
    assert set(saved["anchor"]) == {"perf_counter_ns", "time_ns", "rule"}
