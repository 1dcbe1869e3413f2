"""Where the time of a planning step goes, on one GPU.

    python -m adaptigraph_torch.tools.profile_plan [--trace PATH]

Runs one MPPI planning step (`Planner.trajectory_optimization`, PLAN_ITERS
iterations as plan.py runs them) at configs/planning/rope.yaml's width and
population (20,000 samples in chunks of 2,500) with configs/dynamics/rope.yaml's
model in matmul mode, float32 (weights from
torch.Generator().manual_seed(1), physics param 0.5),
composed as plan.py composes it: the current state is the rope design
point's built rope (5,120 particles) by host FPS, mirrored to the plan frame;
the target is the same points moved to the centre of the action box. Runs
the step once to warm up, then once under torch.profiler, and prints one
JSON line: wall seconds an MPPI iteration, MPPI samples per second, device
busy ms an iteration (the sum of kernel times; one stream, so kernels do
not overlap), the device idle share, kernel launches an iteration, the
kernels with the most device time and the peak memory
(torch.cuda.max_memory_allocated). Optionally writes a Chrome trace. Needs
a CUDA device.

The helpers (the task, the perceived state and target, plan.py's
evaluator, a forward's float32 operations) are shared with chip_smoke.py's
planning path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from adaptigraph_torch.dynamics.rollout import fps_indices
from adaptigraph_torch.planning.costs import (PENALTIES, chunked_cost,
                                              make_error_fn)
from adaptigraph_torch.utils import load_config

PLAN_ITERS = 2  # n_update_iter, as plan.py runs the planner
SEED = 1  # the model's weights (chip_smoke.GNN_SEED)


def plan_task(max_nobj=None, n_chunk=None):
    """configs/planning/rope.yaml's task, max_nobj and n_sample_chunk
    replaced where given."""
    tc = dict(load_config("planning/rope")["task_config"])
    if max_nobj is not None:
        tc["max_nobj"] = max_nobj
    if n_chunk is not None:
        tc["n_sample_chunk"] = n_chunk
    return tc


def plan_points(frame, tc):
    """A rope frame (N, 3), flex frame, as the planner sees a perceived
    state: host FPS to at most max_nobj nodes at the task's fps_radius
    (RandomState(0) draws the radius stage's start), mirrored to the plan
    frame (z negated)."""
    frame = np.asarray(frame, np.float32)
    idx = fps_indices(frame, int(tc["max_nobj"]), float(tc["fps_radius"]),
                      np.random.RandomState(0))
    return frame[idx] * np.array([1, 1, -1], np.float32)


def plan_target(frame, tc):
    """The target pcd: a frame's plan points, translated so that their x-z
    centroid sits at the centre of the action box's x-z range."""
    pts = plan_points(frame, tc)
    lo = np.asarray(tc["action_lower_lim"], np.float32)
    hi = np.asarray(tc["action_upper_lim"], np.float32)
    shift = np.zeros(3, np.float32)
    shift[[0, 2]] = (lo[:2] + hi[:2]) / 2 - pts[:, [0, 2]].mean(0)
    return pts + shift


def plan_state(pts, tc, device):
    """(state (max_nobj, 3), mask (max_nobj,)) on device: pts padded."""
    n_max = int(tc["max_nobj"])
    state = np.zeros((n_max, 3), np.float32)
    state[:len(pts)] = pts[:n_max]
    return (torch.as_tensor(state, device=device),
            torch.as_tensor(np.arange(n_max) < len(pts), device=device))


def plan_evaluator(tc, state, mask, target):
    """plan.py's `_eval_core` in target mode over a pcd: the chamfer
    distance to the target, the task's penalty and its bbox scaled by
    sim_real_ratio, by chunked_cost at the task's n_sample_chunk. Returns
    (evaluate, error_func, penalty, bbox) on state's device."""
    ratio = float(tc["sim_real_ratio"])
    b = np.asarray(tc["bbox"], np.float32)
    bbox = torch.tensor([[b[0] * ratio, b[3] * ratio],
                         [b[2] * ratio, b[5] * ratio]], device=state.device)
    err = make_error_fn(tc, target_state=target, device=state.device)
    pen = PENALTIES[tc["penalty_type"]]
    n_chunk = int(tc.get("n_sample_chunk", 0) or 0)

    def evaluate(state_seqs, act_seqs, state_cur=None, **kw):
        return chunked_cost(state_seqs, act_seqs, state, err, pen, bbox,
                            obj_mask=mask, n_chunk=n_chunk)
    return evaluate, err, pen, bbox


def planner_config(tc, n_sample, rollout_fn, evaluate, device, iters):
    """plan.py's Planner config for the task."""
    return {"action_dim": 4, "model_rollout_fn": rollout_fn,
            "evaluate_traj_fn": evaluate, "n_sample": n_sample,
            "n_look_ahead": int(tc["n_look_ahead"]), "n_update_iter": iters,
            "reward_weight": float(tc["reward_weight"]),
            "action_lower_lim": np.asarray(tc["action_lower_lim"],
                                           np.float32),
            "action_upper_lim": np.asarray(tc["action_upper_lim"],
                                           np.float32),
            "planner_type": "MPPI", "noise_level": float(tc["noise_level"]),
            "push_length": float(tc["push_length"]), "device": device}


def initial_action(tc):
    """plan.py's first incumbent: [-1, 0, 0, action_lower_lim[3]] for each
    look-ahead step."""
    return np.tile(np.array([[-1.0, 0.0, 0.0,
                              float(tc["action_lower_lim"][3])]], np.float32),
                   (int(tc["n_look_ahead"]), 1))


def forward_ops(b, n, n_obj, e, cfg):
    """float32 operations of one forward of b graphs (n nodes, n_obj
    objects, e edges), as (dense, one_hot). `dense` is every dense layer:
    what a forward in any aggregation mode computes, and so what bounds
    it. `one_hot` is what matmul mode adds on top: its gathers (receivers
    and senders at once) and aggregations as products with the (B, 2E, N)
    one-hot incidence, which the segment and slotted modes do without."""
    nf, pstep = cfg.nf, cfg.pstep
    node_w = cfg.attr_dim + 1 + cfg.n_his * 3  # attrs, group, history
    gathers = 2 * b * 2 * e * n * (node_w + pstep * nf)
    aggregate = pstep * 2 * b * n * e * nf
    dense = 2 * b * (n * (cfg.particle_in * nf + 2 * nf * nf)
                     + e * (cfg.relation_in * nf + 2 * nf * nf)
                     + pstep * (e * 3 * nf * nf + n * 2 * nf * nf)
                     + n_obj * (2 * nf * nf + nf * 3))
    return dense, gathers + aggregate


def main(argv=None):
    from adaptigraph_torch.dynamics import DynamicsPredictor
    from adaptigraph_torch.dynamics.model import model_config_from_yaml
    from adaptigraph_torch.planning import Planner
    from adaptigraph_torch.planning.forward_dynamics import (
        make_batched_dynamics)
    from adaptigraph_torch.scenes.design_point import rope_design_point
    from adaptigraph_torch.tools.profile_frame import profiled

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled step here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_plan needs a CUDA device")
    dev = torch.device("cuda")
    tc = plan_task()
    n_sample = int(tc["n_sample"])
    config = load_config("dynamics/rope")
    mc = dataclasses.replace(model_config_from_yaml(
        config["model_config"], config["dataset_config"], 1),
        aggregation="matmul", compute_dtype=torch.float32)
    model = DynamicsPredictor(mc, device=dev, generator=torch.Generator()
                              .manual_seed(SEED)).eval()
    params = dict(model.state_dict())

    b = rope_design_point(dev)
    frame = b.state.particles.pos[:b.n_active].cpu().numpy()
    pts = plan_points(frame, tc)
    st, mk = plan_state(pts, tc, dev)
    phys = torch.tensor([0.5], device=dev)
    rollout = make_batched_dynamics(model, tc)
    evaluate, _, _, _ = plan_evaluator(tc, st, mk, plan_target(frame, tc))
    planner = Planner(planner_config(
        tc, n_sample, lambda sc, a: rollout(params, st, mk, a, phys),
        evaluate, dev, PLAN_ITERS))
    init = initial_action(tc)

    planner.trajectory_optimization(st, init, seed=0)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    res = profiled(lambda: planner.trajectory_optimization(st, init, seed=0),
                   PLAN_ITERS)
    prof = res.pop("profile")
    wall_s = res["wall_ms_per_frame"] / 1e3
    chunk = int(tc.get("n_sample_chunk", 0) or 0)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "samples": n_sample,
        "chunk": chunk, "chunks": -(-n_sample // chunk) if chunk else 1,
        "iterations": PLAN_ITERS, "aggregation": "matmul",
        "nodes": int(tc["max_nobj"]) + len(tc["pusher_points"]),
        "objects": len(pts),
        "wall_s_per_iteration": wall_s,
        "mppi_samples_per_s": n_sample / wall_s,
        "device_busy_ms_per_iteration": res["device_busy_ms_per_frame"],
        "device_idle_share": res["device_idle_share"],
        "kernel_launches_per_iteration": res["kernel_launches_per_frame"],
        "top_kernels": [dict(k, ms_per_iteration=k.pop("ms_per_frame"),
                             launches_per_iteration=k.pop(
                                 "launches_per_frame"))
                        for k in res["top_kernels"]],
        "peak_memory_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
