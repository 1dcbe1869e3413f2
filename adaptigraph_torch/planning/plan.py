"""Closed-loop planning with online physics-parameter adaptation: the port
of adaptigraph_tpu/planning/plan.py.

Perceive -> MPPI over the sampled-action population -> push -> perceive
again -> log the interaction -> refine the physics-parameter estimate.
`--env sim` closes the loop on the simulator (SimPlanEnv: SimEnv on the
device, perception on its rendered frames); `--env real` on the robot
(planning/real_world's RealEnv: the xArm6 and the camera rig).

The planning frame: x right, y up, z the negated flex z (the action frame
of SimEnv.sample_action).

Divergences from the JAX package, by design:
- The model and its weights. JAX builds a DynDataset over data/ and
  restores an orbax checkpoint; the port builds the model of
  task_config['config'] for the material's physics width
  (material_dims), as planning/demo.py does, and loads `params`, a
  state_dict (`main()`: `--params PATH.pt`, saved with torch.save, for
  example `dynamics.model.params_from_jax` of a JAX checkpoint).
- The randomness. JAX splits one key an action from PRNGKey(seed). The
  port's Planner draws action i's proposals from a torch.Generator seeded
  with `action_seed(seed, i)`: the first word of
  np.random.SeedSequence([seed, i]).generate_state(1), so an action's
  draws do not depend on where a resumed run started. `noise_hook`, a
  callable from the action index to a Planner `noise_fn`, replaces those
  draws (the parity tests replay JAX's through it).
- The mesh. As in JAX, the population is split over a 1-D data mesh
  (`_planner_mesh`) when a process group of more than one process is
  running and its size divides n_sample. One process a device here, so
  whenever such a group runs, rank 0 alone drives the environment: it
  perceives, pushes, writes the artefacts and refits the physics
  estimate, and sends each observation and estimate to the other ranks,
  which take part in the Planner's population only (two processes must
  never push one robot). Every rank returns the same stats.
- The planning overlay (rgb_vis_<i>.png, utils/visualize with cv2) never
  stops the loop, as in JAX, but the reason it could not be drawn (cv2
  absent, as on the card's machine) is printed once, not once an action.

Kept as the JAX package has it, for parity:
- A pcd target is loaded and multiplied by sim_real_ratio, its z not
  negated. `--capture-goal` on the simulator saves the perceived cloud in
  the flex frame in sim units (perception.capture_goal), so planning
  toward it in sim mode plans toward a goal sim_real_ratio times too far
  out and mirrored in z. Mirror a captured cloud to the plan frame and
  divide it by the ratio before planning toward it.
- Change mode (random_interact.py) takes the error as minus the chamfer
  distance from the current state; the reward's population-wide weight
  2 / (max error + 1e-6) is then negative, so MPPI picks the push that
  changes the state least.

Usage:
  python -m adaptigraph_torch.planning.plan --task-config planning/rope \\
      --env sim --params rope.pt --name DIR [--use-ppo] [--n-actions 10] \\
      [--n-sample 1024] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
from types import SimpleNamespace
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from adaptigraph_torch.dynamics.train import init_model
from adaptigraph_torch.ops.losses import box_loss, chamfer
from adaptigraph_torch.planning.actions import decode_action_single
from adaptigraph_torch.parallel.mesh import (init_from_env, make_mesh,
                                             replicate, world_size)
from adaptigraph_torch.planning.costs import PENALTIES, chunked_cost
from adaptigraph_torch.planning.forward_dynamics import make_batched_dynamics
from adaptigraph_torch.planning.perception import (PerceptionModule,
                                                   capture_goal)
from adaptigraph_torch.planning.physics_optimizer import (
    PhysicsParamOnlineOptimizer)
from adaptigraph_torch.planning.planner import Planner
from adaptigraph_torch.utils import load_config
from adaptigraph_torch.utils.device import resolve_device

FAR = (1e3, -1e2, 1e3)  # where get_obs moves the shapes it hides


def _planner_mesh(n_sample, device=None):
    """The 1-D data mesh over the running process group's world when it
    holds more than one process and its size divides n_sample; None (one
    device holds the population) otherwise. JAX's rule over the visible
    devices (plan.py:45-54)."""
    n = world_size()
    if n > 1 and n_sample % n == 0:
        return make_mesh(n, device=device)
    return None


def _share(obj):
    """Rank 0's `obj` on every rank of the running process group (itself
    without one)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def flex_to_plan(points):
    """World (flex) -> planning frame: negate z."""
    out = np.asarray(points).copy()
    out[..., 2] *= -1
    return out


def action_seed(seed: int, i: int) -> int:
    """The seed of action i's proposal draws in a run seeded with `seed`."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


class SimPlanEnv:
    """SimEnv behind the planning-environment interface (get_obs, step,
    cam_intr, cam_extr, units), on `device` (CUDA unless given)."""

    units = "sim"  # get_obs depths are in sim units (see plan()'s scaling)

    def __init__(self, data_gen_config, seed=0, device=None):
        from adaptigraph_torch.sim.env import SimEnv

        self.env = SimEnv(data_gen_config, device=device)
        self.env.reset(seed=seed)
        self.cam_intr = self.env.cam_intrinsic_params
        self.cam_extr = self.env.cam_extrinsic_matrix

    def get_obs(self):
        """(colors (4, H, W, 3), depths (4, H, W)) of the 4 cameras, rendered
        without the tool, the arm and the robot's side table: the sim's
        stand-in for a segmentation prompted with the object's name, which
        the depth segmenter alone is not (it keeps all that stands above
        the table)."""
        env = self.env
        shapes = env.state.shapes
        pos = shapes.pos.clone()
        far = torch.tensor(FAR, dtype=pos.dtype, device=pos.device)
        pos[env.tool_slot0: env.tool_slot0 + env.n_tool] = far
        if env.n_arm:
            pos[env.arm_slot0: env.arm_slot0 + env.n_arm] = far
        pos[env.table_slot] = far
        imgs = env._render_multiview(
            env.state.particles.pos.cpu().numpy(),
            shapes=shapes._replace(pos=pos, prev_pos=pos))
        return imgs[:, :, :, :3], imgs[:, :, :, 4]

    def step(self, action4):
        return self.env.step(np.asarray(action4), save_data=False)


def _observe(env):
    colors, depths = env.get_obs()
    return colors, depths, env.cam_intr, env.cam_extr


def load_model(task_config, params, device):
    """The task's dynamics model (task_config['config'] at the material's
    physics width) on `device`, holding `params` (a state_dict), in eval
    mode."""
    dyn_config = load_config(task_config["config"])
    material = task_config["material"]
    phys = SimpleNamespace(
        phys_dim=int(task_config["material_dims"][material]))
    model, _ = init_model(dyn_config, phys, device=device)
    model.load_state_dict(params, strict=True)
    model.eval()
    return model


class Reward(NamedTuple):
    """plan()'s reward terms on one device.

    error(flat, target, tmask, mflat=None): the final error of states flat
    (B, N, 3) under mask mflat: the distance to the task's box, the
    chamfer distance to `target` (M, 3), or in change mode minus the
    chamfer distance from the current state `target` under `tmask`.
    penalty: the task's collision penalty; bbox: the workspace (2, 2) in
    plan-frame sim units; target: the pcd target (M, 3) in plan-frame sim
    units, or None. evaluate(state_seqs, act_seqs, state_pad, obj_mask,
    target, tmask): the population's rewards, chunked_cost at the task's
    n_sample_chunk."""

    error: Callable
    penalty: Callable
    bbox: torch.Tensor
    target: torch.Tensor | None
    evaluate: Callable


def make_reward(task_config, reward_mode, device) -> Reward:
    """plan()'s reward for `reward_mode` ('target' or 'change'). The pcd
    target is read from task_config['target'] and multiplied by
    sim_real_ratio; its z is not negated (see the module docstring)."""
    tc = task_config
    ratio = float(tc["sim_real_ratio"])
    tgt_type = tc.get("target_type")

    def on(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    target_pcd = box = None
    if reward_mode == "target":
        if tgt_type == "box":
            box = on(np.asarray(tc["target"], np.float32).reshape(2, 2)
                     * ratio)
        else:
            target_pcd = on(np.load(tc["target"]) * ratio)
    b = np.asarray(tc["bbox"], np.float32)
    bbox = on([[b[0] * ratio, b[3] * ratio], [b[2] * ratio, b[5] * ratio]])
    penalty = PENALTIES[tc["penalty_type"]]
    n_chunk = int(tc.get("n_sample_chunk", 0) or 0)

    def error(flat, target, tmask, mflat=None):
        if reward_mode == "target" and tgt_type == "box":
            return box_loss(flat, box)
        if reward_mode == "change":
            return -chamfer(flat, target[None], x_mask=mflat,
                            y_mask=tmask[None])
        return chamfer(flat, target[None], x_mask=mflat)

    def evaluate(state_seqs, act_seqs, state_pad, obj_mask, target, tmask):
        def err(flat, mflat):
            return error(flat, target, tmask, mflat)
        return chunked_cost(state_seqs, act_seqs, state_pad, err, penalty,
                            bbox, obj_mask=obj_mask, n_chunk=n_chunk)

    return Reward(error, penalty, bbox, target_pcd, evaluate)


def plan(task_config, env, save_dir, params, use_ppo=False, n_actions=None,
         n_sample=None, n_update_iter=2, resume=False, seed=0,
         reward_mode="target", device=None, noise_hook=None):
    """Run the closed loop for n_actions pushes (the task's when None) on
    `env`, writing interaction_<i>.npz, stats.txt (rows: action index, the
    chosen sample's reward, the real final error, the predicted final
    error) and, with use_ppo, ppo_<i>.npz into save_dir. `params` is a
    state_dict of the task's dynamics model; the model, the population and
    the physics optimiser run on `device` (CUDA unless given).
    reward_mode: 'target' (the task's box or pcd) or 'change' (away from
    the current state). Returns the stats rows. Under a process group of
    several processes every rank calls plan(); only rank 0's `env` is
    used (the others may pass None)."""
    device = resolve_device(device)
    tc = task_config
    n_actions = n_actions or int(tc["n_actions"])
    n_sample = n_sample or int(tc["n_sample"])
    mesh = _planner_mesh(n_sample, device)
    # rank 0 alone touches the environment and the files (every rank when
    # no process group runs is rank 0)
    lead = world_size() == 1 or dist.get_rank() == 0
    material = tc["material"]
    sim_real_ratio = float(tc["sim_real_ratio"])
    model = load_model(tc, params, device)
    params = dict(model.state_dict())
    if mesh is not None:
        params = replicate(params, mesh)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    terms = make_reward(tc, reward_mode, device)
    tgt_type = tc.get("target_type")
    max_nobj = int(tc["max_nobj"])
    rollout = make_batched_dynamics(model, tc)
    if lead:
        os.makedirs(save_dir, exist_ok=True)
        # env-native units: SimPlanEnv perceives in sim units, a real rig
        # in table meters; real states scale by sim_real_ratio before
        # planning, and the perception geometry switches to meters
        # (workspace = bbox)
        units = getattr(env, "units", "sim")
        if units == "real":
            bb = np.asarray(tc["bbox"], np.float32).reshape(2, 3)
            ws = np.stack([np.minimum(bb[0], bb[1]),
                           np.maximum(bb[0], bb[1])], axis=1)
            perception = PerceptionModule(
                tc, table_height=float(tc.get("table_height", 0.0)),
                voxel=0.002, workspace=ws)
            state_scale = sim_real_ratio
        else:
            perception = PerceptionModule(tc)
            state_scale = 1.0
        ppm = PhysicsParamOnlineOptimizer(tc, model, params, material,
                                          save_dir, device=device)

    start_i = 0
    if resume and lead:
        start_i = len(glob.glob(os.path.join(save_dir, "interaction_*.npz")))
    start_i = _share(start_i)

    init_act = np.tile(np.array([[-1.0, 0.0, 0.0,
                                  float(tc["action_lower_lim"][3])]],
                                np.float32), (int(tc["n_look_ahead"]), 1))
    stats = []
    overlay_failed = False
    for i in range(start_i, n_actions):
        seen = None
        if lead:
            colors, depths, intrs, extrs = _observe(env)
            state_cur_raw, _ = perception.get_state_cur(colors, depths,
                                                        intrs, extrs)
            state_cur = flex_to_plan(state_cur_raw * state_scale)
            seen = (state_cur, ppm.physics_param[material])
        state_cur, phys_now = _share(seen)
        nobj = min(len(state_cur), max_nobj)
        state_pad = np.zeros((max_nobj, 3), np.float32)
        state_pad[:nobj] = state_cur[:nobj]
        obj_mask = np.zeros(max_nobj, bool)
        obj_mask[:nobj] = True

        phys = on(phys_now)
        state_pad_d = on(state_pad)
        obj_mask_d = on(obj_mask, torch.bool)
        if reward_mode == "change":
            target_d, tmask_d = state_pad_d, obj_mask_d
        elif tgt_type == "pcd":
            target_d, tmask_d = terms.target, None
        else:  # the box target is read by the error itself
            target_d, tmask_d = state_pad_d, None

        def model_rollout(sc, act_seqs):
            return rollout(params, state_pad_d, obj_mask_d, act_seqs, phys)

        def evaluate(state_seqs, act_seqs, state_cur=None, **kw):
            return terms.evaluate(state_seqs, act_seqs, state_pad_d,
                                  obj_mask_d, target_d, tmask_d)

        planner = Planner({
            "action_dim": 4,
            "model_rollout_fn": model_rollout,
            "evaluate_traj_fn": evaluate,
            "n_sample": n_sample,
            "n_look_ahead": int(tc["n_look_ahead"]),
            "n_update_iter": n_update_iter,
            "reward_weight": float(tc["reward_weight"]),
            "action_lower_lim": np.asarray(tc["action_lower_lim"], np.float32),
            "action_upper_lim": np.asarray(tc["action_upper_lim"], np.float32),
            "planner_type": "MPPI",
            "noise_level": float(tc["noise_level"]),
            "push_length": float(tc["push_length"]),
            "device": device,
            "noise_fn": noise_hook(i) if noise_hook is not None else None,
            "mesh": mesh,
        })
        res = planner.trajectory_optimization(state_pad_d, init_act,
                                              seed=action_seed(seed, i))
        if not lead:
            continue
        act = res["act_seq"][0].cpu().numpy()
        state_pred = (res["best_model_output"]["state_seqs"][0, -1]
                      .cpu().numpy())
        reward = float(res["best_eval_output"]["reward_seqs"][0])
        # the reward of the chosen action alone is normalised by its own
        # error (about -2); its predicted final error compares across actions
        err_pred = float(res["best_eval_output"]["error_seqs"][0])
        print(f"action {i}: act {np.round(act, 3)} reward {reward:.4f} "
              f"pred_error {err_pred:.4f}", flush=True)

        # the planning overlay never stops the control loop
        try:
            _write_overlay(os.path.join(save_dir, f"rgb_vis_{i}.png"), tc,
                           reward_mode, colors[0], intrs[0], extrs[0],
                           state_cur[:nobj], state_pred[:nobj], act, units,
                           sim_real_ratio)
        except Exception as e:
            if not overlay_failed:
                print(f"the planning overlay is not drawn: "
                      f"{type(e).__name__}: {e}", flush=True)
            overlay_failed = True

        xs, zs, xe, ze = decode_action_single(act, float(tc["push_length"]))
        env.step(np.array([xs, zs, xe, ze]))

        colors, depths, intrs, extrs = _observe(env)
        state_real_raw, _ = perception.get_state_cur(colors, depths, intrs,
                                                     extrs)
        state_real = flex_to_plan(state_real_raw * state_scale)

        ppm.log_interaction(i, act, state_cur[:nobj], state_pred[:nobj],
                            state_real)
        with torch.no_grad():
            err_fin = float(terms.error(on(state_real)[None], target_d,
                                        tmask_d)[0])
        stats.append((i, reward, err_fin, err_pred))
        # written after every action: a run cut short keeps what it did
        np.savetxt(os.path.join(save_dir, "stats.txt"), np.asarray(stats))
        print(f"action {i}: final error {err_fin:.4f}", flush=True)

        if use_ppo:
            ppm.optimize(i, iterations=int(os.environ.get("PPO_ITERS", 50)))

    if lead:
        np.savetxt(os.path.join(save_dir, "stats.txt"), np.asarray(stats))
    return _share(stats)


def _write_overlay(path, tc, reward_mode, color, intr, extr, state_cur,
                   state_pred, act, units, sim_real_ratio):
    """The planning overlay of one action (plan_utils.py:104-281): the
    state, the action's arrows, the target and the prediction, drawn on
    camera 0's frame with cv2 and written to `path`."""
    import cv2

    from adaptigraph_torch.utils.visualize import overlay_plan

    tgt_pcd = tgt_box = None
    if reward_mode == "target" and tc["target_type"] == "box":
        tgt_box = np.asarray(tc["target"], np.float32) * sim_real_ratio
    elif reward_mode == "target":
        tgt_pcd = np.load(tc["target"]) * sim_real_ratio
    vis = overlay_plan(
        color, state_cur, state_pred, act, intr, extr, target_state=tgt_pcd,
        target_box=tgt_box, push_length=float(tc["push_length"]),
        adj_thresh=float(tc["adj_thresh"]), topk=int(tc["topk"]),
        units=units, sim_real_ratio=sim_real_ratio)
    cv2.imwrite(path, vis[..., ::-1])


def make_env(task_config, env_kind, device=None, **real_kw):
    """The planning environment of `env_kind` for the task: 'sim' a
    SimPlanEnv on `device`, 'real' a RealEnv (planning/real_world) built
    with `real_kw` (its defaults drive the xArm6 and RealSense cameras;
    use_robot=False and use_real_cameras=False take the doubles). A
    RealEnv is started by its caller."""
    if env_kind == "real":
        from adaptigraph_torch.planning.real_world.real_env import RealEnv

        return RealEnv(task_config=task_config, **real_kw)
    dg = load_config(f"data_gen/{task_config['material']}")
    return SimPlanEnv(dg, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task-config", type=str, default="planning/rope")
    ap.add_argument("--env", type=str, default="sim", choices=["sim", "real"])
    ap.add_argument("--use-ppo", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--n-actions", type=int, default=None)
    ap.add_argument("--n-sample", type=int, default=None)
    ap.add_argument("--name", type=str, default="dump/plan")
    ap.add_argument("--params", type=str, default=None,
                    help="a state_dict saved with torch.save (needed to plan)")
    ap.add_argument("--capture-goal", type=str, default=None,
                    metavar="OUT_NPY",
                    help="capture the target pcd from live frames and exit")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    init_from_env(args.device)
    tc = load_config(args.task_config)["task_config"]
    if world_size() > 1 and dist.get_rank() > 0:
        env = None  # rank 0 alone drives the environment
    else:
        env = make_env(tc, args.env, device=resolve_device(args.device))
    if args.env == "real" and env is not None:
        env.start()
    if args.capture_goal:
        if env is not None:
            pts = capture_goal(env, PerceptionModule(tc), args.capture_goal)
            print(f"captured goal pcd: {len(pts)} points -> "
                  f"{args.capture_goal}")
        return
    if args.params is None:
        ap.error("--params is needed to plan")
    params = torch.load(args.params, map_location="cpu", weights_only=True)
    plan(tc, env, args.name, params, use_ppo=args.use_ppo,
         n_actions=args.n_actions, n_sample=args.n_sample, resume=args.resume,
         device=args.device)


if __name__ == "__main__":
    main()
