"""Autoregressive rollout evaluation: the port of
adaptigraph_tpu/dynamics/rollout.py.

For each validation episode and push, build the start graph with
deterministic mid-range FPS and adjacency radii, then roll the model
forward up to `rollout_steps` steps: each step rebuilds the radius edges
from the PREDICTED state, slides the history window, and walks the
frame-pair table for the next (start, end) anchor. Error = mean particle L2
against the FPS-subsampled ground truth. The step (model forward, edge
rebuild, window slide) runs on the graph's device; the pair walk stays on
the host.

`viz` writes the overlay of predicted and true frames (utils/visualize,
with cv2) on camera 0 of each push's stored frames (the episodes' NN.npz)
and merges them into a video.

Usage: python -m adaptigraph_torch.dynamics.rollout --config dynamics/rope
       --params PARAMS.pt [--steps N] [--no-scan] [--viz] [--device cpu]
PARAMS.pt is a state_dict saved with torch.save, for example
`params_from_jax` of a JAX checkpoint.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from adaptigraph_torch.dynamics.dataset import DynDataset, episode_names
from adaptigraph_torch.dynamics.train import init_model, make_apply
from adaptigraph_torch.ops import build_edges, build_edges_slotted
from adaptigraph_torch.utils import load_config
from adaptigraph_torch.utils.device import resolve_device
from adaptigraph_torch.utils.host_fps import fps_rad_idx, fps_with_idx

_SLOTTED = ("slotted", "slotmm")


def fps_indices(points, max_nobj, radius, rng):
    """Two-stage FPS of the reference (dataset/graph.py:8-36), host-side."""
    _, idx1 = fps_with_idx(points, min(max_nobj, len(points)))
    sub = points[idx1]
    _, idx2 = fps_rad_idx(sub, radius, rng)
    return idx1[np.asarray(idx2, int)]


def construct_graph(dataset_config, eef_pos, obj_pos, n_his, pair,
                    physics_param, rng=None, slotted=False, device=None):
    """Start graph for a rollout (rollout/graph.py:233-372 in the
    reference): numpy on the host, then tensors on `device` (CUDA unless
    given). `rng` (a np.random.RandomState) draws the radius FPS's start.

    slotted=True emits slot-layout edges for models in a slotted
    aggregation mode (the same valid edge set; see
    ops.build_edges_slotted). Returns (graph dict, fps_idx)."""
    device = resolve_device(device)
    ds = dataset_config["datasets"][0]
    max_nobj = int(ds["max_nobj"])
    max_nR = int(ds["max_nR"])
    fps_radius = float(np.mean(ds["fps_radius_range"]))
    adj_thresh = float(np.mean(ds["adj_radius_range"]))
    n_eef = eef_pos.shape[1]
    state_dim = max_nobj + n_eef
    rng = rng or np.random

    obj_kps = np.stack([obj_pos[p] for p in pair])  # (T, N_raw, 3)
    eef_kps = np.stack([eef_pos[p] for p in pair])

    fps_idx = fps_indices(obj_kps[n_his - 1], max_nobj, fps_radius, rng)
    nobj = len(fps_idx)
    obj_kp = np.zeros((len(pair), max_nobj, 3), np.float32)
    obj_kp[:, :nobj] = obj_kps[:, fps_idx]

    states_delta = np.zeros((state_dim, 3), np.float32)
    states_delta[max_nobj:] = eef_kps[n_his] - eef_kps[n_his - 1]

    state_history = np.concatenate([obj_kp[:n_his], eef_kps[:n_his]], axis=1)

    obj_mask = np.zeros(max_nobj, bool)
    obj_mask[:nobj] = True
    state_mask = np.concatenate([obj_mask, np.ones(n_eef, bool)])
    eef_mask = np.concatenate([np.zeros(max_nobj, bool), np.ones(n_eef, bool)])
    attrs = np.zeros((state_dim, 2), np.float32)
    attrs[:nobj, 0] = 1.0
    attrs[max_nobj:, 1] = 1.0
    p_instance = obj_mask.astype(np.float32)[:, None]

    def on(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    graph = {
        "state": on(state_history),
        "action": on(states_delta),
        "attrs": on(attrs),
        "p_instance": on(p_instance),
        "obj_mask": on(obj_mask, torch.bool),
        "state_mask": on(state_mask, torch.bool),
        "eef_mask": on(eef_mask, torch.bool),
        "physics_param": on(physics_param),
    }
    if slotted:
        edges = build_edges_slotted(
            graph["state"][-1], adj_thresh, graph["state_mask"],
            graph["eef_mask"], topk=int(ds["topk"]),
            connect_tools_all=bool(ds["connect_tool_all"]), tool_slots=n_eef)
    else:
        edges = build_edges(
            graph["state"][-1], adj_thresh, graph["state_mask"],
            graph["eef_mask"], topk=int(ds["topk"]),
            connect_tools_all=bool(ds["connect_tool_all"]), max_edges=max_nR)
    graph.update(recv=edges.receivers, send=edges.senders,
                 edge_valid=edges.valid)
    return graph, fps_idx


def get_next_pair(pairs, n_his, current_end, n_frames=None, scan=False):
    """Frame-pair table walk (rollout/graph.py:392-400 in the reference).
    With scan=True, when no pair starts exactly at current_end, scan
    FORWARD over frames until one does (the reference's
    get_next_pair_or_break_episode), so that a rollout chains across push
    boundaries."""
    valid = pairs[pairs[:, n_his - 1] == current_end]
    valid = valid[valid[:, n_his] > current_end]
    if len(valid) == 0:
        if not scan or n_frames is None:
            return None
        while current_end < n_frames - 1:
            current_end += 1
            valid = pairs[pairs[:, n_his - 1] == current_end]
            valid = valid[valid[:, n_his] > current_end]
            if len(valid):
                break
        if len(valid) == 0:
            return None
    return valid[len(valid) // 2]


def make_rollout_step(model, dataset_config):
    """step(params, graph, eef_start, eef_end) -> (pred, new_graph): one
    autoregressive step (rollout.py:67-138 in the reference): the forward,
    the edges rebuilt from the prediction, the history slid by one."""
    ds = dataset_config["datasets"][0]
    adj_thresh = float(np.mean(ds["adj_radius_range"]))
    topk = int(ds["topk"])
    cta = bool(ds["connect_tool_all"])
    max_nR = int(ds["max_nR"])
    slotted = model.cfg.aggregation in _SLOTTED
    apply = make_apply(model)

    @torch.no_grad()
    def step(params, graph, eef_start, eef_end):
        pred, _ = apply(params, graph)
        pred = torch.where(graph["obj_mask"][:, None], pred,
                           torch.zeros_like(pred))
        states = torch.cat([pred, eef_start], dim=0)
        delta = torch.cat([torch.zeros_like(pred), eef_end - eef_start],
                          dim=0)
        if slotted:
            edges = build_edges_slotted(
                states, adj_thresh, graph["state_mask"], graph["eef_mask"],
                topk=topk, connect_tools_all=cta,
                tool_slots=eef_start.shape[0])
        else:
            edges = build_edges(states, adj_thresh, graph["state_mask"],
                                graph["eef_mask"], topk=topk,
                                connect_tools_all=cta, max_edges=max_nR)
        state_history = torch.cat([graph["state"][1:], states[None]], dim=0)
        new_graph = dict(graph, state=state_history, action=delta,
                         recv=edges.receivers, send=edges.senders,
                         edge_valid=edges.valid)
        return pred, new_graph

    return step


def rollout_push(params, step_fn, graph, fps_idx, pairs, eef_pos, obj_pos,
                 n_his, current_start, current_end, max_nobj,
                 rollout_steps=100, viz_ctx=None, scan=False):
    """Roll one push; returns the per-step error list. `viz_ctx` (optional):
    dict(imgs, intr, extr, save_dir): writes each step's overlay of the
    predicted points and edges, the true points and the tool point
    (<step>_both.jpg), as the reference's visualize_graph
    (rollout/graph.py:44-230)."""
    dev = graph["state"].device
    errors = []
    for step_i in range(rollout_steps):
        eef_start = torch.as_tensor(eef_pos[current_start],
                                    dtype=torch.float32, device=dev)
        eef_end = torch.as_tensor(eef_pos[current_end], dtype=torch.float32,
                                  device=dev)
        # note: the reference applies the NEXT action before computing the
        # error at current_end: the graph already encodes the action toward
        # current_end
        pred, graph = step_fn(params, graph, eef_start, eef_end)
        gt = obj_pos[current_end][fps_idx]
        predn = pred.cpu().numpy()[: len(fps_idx)]
        errors.append(float(np.linalg.norm(predn - gt, axis=-1).mean()))
        if viz_ctx is not None:
            _write_overlay(viz_ctx, step_i, current_end, predn, graph, gt,
                           eef_end.cpu().numpy())
        nxt = get_next_pair(pairs, n_his, current_end,
                            n_frames=len(obj_pos), scan=scan)
        if nxt is None:
            break
        current_start, current_end = nxt[n_his - 1], nxt[n_his]
    return errors


def _write_overlay(viz_ctx, step_i, frame, predn, graph, gt, eef):
    import cv2

    from adaptigraph_torch.utils.visualize import overlay_graph

    img = viz_ctx["imgs"][min(frame, len(viz_ctx["imgs"]) - 1)]
    out = overlay_graph(img, predn, viz_ctx["intr"], viz_ctx["extr"],
                        edges=(graph["recv"].cpu().numpy(),
                               graph["send"].cpu().numpy(),
                               graph["edge_valid"].cpu().numpy()),
                        gt_kp=gt, eef_kp=eef)
    cv2.imwrite(os.path.join(viz_ctx["save_dir"], f"{step_i}_both.jpg"),
                out[..., ::-1])


def make_viz_ctx(dataset_config, name, push_i, out_dir, cam=0):
    """Camera `cam`'s stored frames of episode `name` (its pushes' NN.npz,
    from 01 on) and the cameras' parameters, for rollout_push's overlay;
    None when the episode has no cameras or frames (the reference's
    extract_imgs, rollout/graph.py:20-40)."""
    from adaptigraph_torch.sim.episode_io import load_data

    data_dir = os.path.join(dataset_config["data_dir"],
                            dataset_config["data_name"])
    cam_dir = os.path.join(data_dir, "cameras")
    if not os.path.exists(os.path.join(cam_dir, "intrinsic.npy")):
        return None
    intr = np.load(os.path.join(cam_dir, "intrinsic.npy"))[cam]
    extr = np.load(os.path.join(cam_dir, "extrinsic.npy"))[cam]
    imgs = [load_data(f)["observations"]["color"][f"cam_{cam}"] for f in
            sorted(glob.glob(os.path.join(data_dir, name, "*.npz")))[1:]]
    if not imgs:
        return None
    imgs = np.concatenate(imgs, axis=0)
    # the shared intrinsics are those of the last campaign's resolution;
    # they scale linearly with the image (fx = (W/2)/tan(fov/2), cx = W/2)
    scale = imgs.shape[2] / (2.0 * float(intr[2]))
    if abs(scale - 1.0) > 1e-6:
        intr = intr * scale
    save_dir = os.path.join(out_dir, f"viz_{name}_{push_i + 1}_cam{cam}")
    os.makedirs(save_dir, exist_ok=True)
    return {"imgs": imgs, "intr": intr, "extr": extr, "save_dir": save_dir}


def rollout(config, params, viz=False, max_episodes=None, rollout_steps=None,
            scan=True, device=None):
    """Roll every validation push of the config's dataset with the model
    `params` (a state_dict of the config's DynamicsPredictor) on `device`
    (CUDA unless given); writes the per-push error files, the median curve
    and the error plot under rollout_config.out_dir, and returns the
    per-push error lists. One np.random.RandomState(42) draws every start
    graph's radius FPS start, in order. `viz` also writes each push's
    overlay frames and video (make_viz_ctx; cv2)."""
    device = resolve_device(device)
    dataset_config = config["dataset_config"]
    rollout_steps = rollout_steps or int(
        config["rollout_config"]["rollout_steps"])
    out_dir = os.path.join(config["rollout_config"]["out_dir"],
                           dataset_config["data_name"])
    os.makedirs(out_dir, exist_ok=True)

    dataset = DynDataset(dataset_config, config["material_config"], "valid")
    model, _ = init_model(config, dataset, device=device)
    model.load_state_dict(params, strict=True)
    model.eval()
    params = dict(model.state_dict())
    step_fn = make_rollout_step(model, dataset_config)
    slotted = model.cfg.aggregation in _SLOTTED

    n_his = dataset.n_his
    prep_dir = os.path.join(dataset_config["prep_data_dir"],
                            dataset_config["data_name"], "frame_pairs")
    data_dir = os.path.join(dataset_config["data_dir"],
                            dataset_config["data_name"])
    names = episode_names(data_dir, prep_dir)
    num_epis = len(names)
    ratio = dataset_config["ratio"]["valid"]
    epi_range = list(range(int(num_epis * ratio[0]),
                           int(num_epis * ratio[1])))
    if max_episodes:
        epi_range = epi_range[:max_episodes]

    all_errors = []
    rng = np.random.RandomState(42)
    max_nobj = int(dataset_config["datasets"][0]["max_nobj"])
    for epi in epi_range:
        name = names[epi]
        pair_files = sorted(glob.glob(os.path.join(prep_dir, f"{name}_*.txt")))
        eef_pos, obj_pos = dataset.eef_pos[epi], dataset.obj_pos[epi]
        physics = dataset.physics_params[epi][dataset.material]
        # the episode-wide pair table: a rollout started at one push chains
        # into the following pushes (rollout.py:207-239 in the reference)
        tables = [np.atleast_2d(np.loadtxt(pf).astype(int))
                  for pf in pair_files]
        tables = [t for t in tables if t.size and t.shape[0] > 1]
        if not tables:
            continue
        pairs_all = np.vstack(tables)
        for pi, pairs in enumerate(tables):
            pair = pairs[0]
            graph, fps_idx = construct_graph(
                dataset_config, eef_pos, obj_pos, n_his, pair, physics, rng,
                slotted=slotted, device=device)
            viz_ctx = (make_viz_ctx(dataset_config, name, pi, out_dir)
                       if viz else None)
            errors = rollout_push(
                params, step_fn, graph, fps_idx, pairs_all, eef_pos, obj_pos,
                n_his, pair[n_his - 1], pair[n_his], max_nobj, rollout_steps,
                viz_ctx=viz_ctx, scan=scan)
            if viz_ctx is not None:
                from adaptigraph_torch.utils.visualize import merge_video

                merge_video(viz_ctx["save_dir"], "both",
                            os.path.join(viz_ctx["save_dir"], "both.mp4"),
                            fps=10)
            all_errors.append(errors)
            np.savetxt(os.path.join(out_dir, f"error_{name}_{pi + 1}.txt"),
                       errors)
            print(f"episode {epi} push {pi + 1}: {len(errors)} steps, final "
                  f"err {errors[-1] if errors else float('nan'):.4f}",
                  flush=True)

    if all_errors:
        max_len = max(len(e) for e in all_errors)
        mat = np.full((len(all_errors), max_len), np.nan)
        for i, e in enumerate(all_errors):
            mat[i, : len(e)] = e
        med = np.nanmedian(mat, axis=0)
        np.savetxt(os.path.join(out_dir, "error_median.txt"), med)
        print(f"median error over horizon: start {med[0]:.4f} end "
              f"{med[-1]:.4f}")
        save_error_plot(all_errors, out_dir)
    return all_errors


def save_error_plot(all_errors, out_dir, save_name="error_short"):
    """Median + 25/75-percentile band over the rollout horizon: the
    reference's error_short.txt/png (rollout.py:244-273: rows are pushes
    truncated to the shortest horizon, columns time steps). Imports
    matplotlib when called."""
    min_step = min(len(e) for e in all_errors)
    if min_step == 0:
        return
    step_error = np.stack([np.asarray(e[:min_step]) for e in all_errors],
                          axis=1)
    np.savetxt(os.path.join(out_dir, f"{save_name}.txt"), step_error)
    median = np.median(step_error, axis=1)
    p75 = np.percentile(step_error, 75, axis=1)
    p25 = np.percentile(step_error, 25, axis=1)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 5))
    plt.plot(median)
    plt.xlabel("time step")
    plt.ylabel("error")
    plt.grid()
    plt.gca().fill_between(np.arange(len(median)), p25, p75, alpha=0.2)
    plt.savefig(os.path.join(out_dir, f"{save_name}.png"), dpi=300)
    plt.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=str, default="dynamics/rope")
    ap.add_argument("--params", type=str, required=True,
                    help="a state_dict saved with torch.save")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--viz", action="store_true",
                    help="write each push's overlay frames and video (cv2)")
    ap.add_argument("--no-scan", action="store_true",
                    help="per-push horizon only (the reference's "
                         "get_next_pair_or_break_episode_pushes walk)")
    args = ap.parse_args(argv)
    params = torch.load(args.params, map_location="cpu", weights_only=True)
    rollout(load_config(args.config), params, viz=args.viz,
            rollout_steps=args.steps, scan=not args.no_scan,
            device=args.device)


if __name__ == "__main__":
    main()
