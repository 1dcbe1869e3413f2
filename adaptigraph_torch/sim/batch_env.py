"""Batched episode generation: the port of adaptigraph_tpu/sim/batch_env.py.

B SimEnvs advance in lockstep, one push each, with single-env semantics:
each push is planned by `SimEnv.plan_push`, runs through the lone env's
group body (`SimEnv._push_group`), is captured on the lone env's
contact-gated cadence (`SimEnv._capture_push`), and an invalid push is
retried per env (up to MAX_RETRY) while the others hold a parked no-op.
The validity gate is the reference's colour-difference rule on one
capture view per env.

The JAX package vmaps the B environments through one jitted program. The
port's frame takes one scene, so here a batch is a loop over the B envs
that keeps that program's semantics:
- every env runs n_active chunks, the most any env's push needs capped at
  max_chunks, parked envs and shorter pushes included;
- the explosion guard flags an env and does not stop it (the lone push
  stops at its first bad group);
- the attach path is a batch-wide fact: every env takes it when any env
  grasps;
- every env's spec is padded to the batch's widest incidence tables and
  cluster matrix, as a stacked spec must be. A re-padded cluster matrix
  changes its matmul's inner dimension, so such an env may round
  otherwise than a lone SimEnv; an env that kept its widths runs the lone
  env's arithmetic.

A batched frame (kernels with a scene axis) is what would give a batch
its throughput; this loop gives none over the lone env.

Usage:
  python -m adaptigraph_torch.sim.batch_env --config data_gen/rope \\
      --n-episode 8 --batch 4 --out DIR [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from adaptigraph_torch.engine.state import (
    build_cluster_incidence, build_spring_incidence, pad_cluster_matmul)
from adaptigraph_torch.sim.env import CHUNK, SimEnv, _f32, _fwd_from_angle
from adaptigraph_torch.sim.episode_io import save_property_params, store_data
from adaptigraph_torch.sim.render import render_frames_batch
from adaptigraph_torch.utils import load_config
from adaptigraph_torch.utils.device import resolve_device

MAX_RETRY = 10  # data_gen.py:86-94
PARKED_ACTION = np.array([3.9, 3.9, 3.95, 3.95])  # a short push, then lifted
PARKED_LIFT = np.array([0.0, 19.0, 0.0], np.float32)


class BatchSimEnv:
    """B SimEnvs on one device advanced in lockstep, one push each."""

    GATE_RES = 180  # the validity gate's render resolution

    def __init__(self, config, batch: int, device=None):
        self.batch = batch
        self.device = resolve_device(device)
        self.envs = [SimEnv(config, device=self.device) for _ in range(batch)]
        for e in self.envs:
            # a batch's specs share their shapes: no per-scene bucketing
            e.bucket_caps = False
        self.repadded = [False] * batch  # which envs' specs were re-padded
        # the last run_pushes' frames an env and seconds; the last
        # render_all's seconds
        self.stats, self.render_seconds = {}, None

    def reset(self, seeds):
        """Build every env's scene, align the specs, and settle every env
        with a parked no-op covering ceil(settle_steps / CHUNK) chunks."""
        for env, seed in zip(self.envs, seeds):
            env.reset(seed=int(seed), save_data=False, settle=False)
        self.substeps, self.iterations = (self.envs[0].substeps,
                                          self.envs[0].iterations)
        self.repadded = [False] * self.batch
        self._align_incidence()
        self._align_cluster_mm()
        self.run_pushes([None] * self.batch)
        for env in self.envs:
            env.finish_reset(save_data=False)

    def _align_incidence(self):
        """Rebuild every env's incidence tables at the batch-wide largest
        degree (the degree varies with the sampled physics)."""
        specs = [e.spec for e in self.envs]
        d_c = max((s.cluster_inc.idx.shape[1] for s in specs
                   if s.cluster_inc is not None), default=0)
        d_s = max((s.spring_inc.idx.shape[1] for s in specs
                   if s.spring_inc is not None), default=0)
        for i, env in enumerate(self.envs):
            s = env.spec
            n = s.rest_pos.shape[0]
            if s.cluster_inc is not None and s.cluster_inc.idx.shape[1] != d_c:
                s = s._replace(cluster_inc=build_cluster_incidence(
                    s.clusters, n, d_max=d_c))
                self.repadded[i] = True
            if s.spring_inc is not None and s.spring_inc.idx.shape[1] != d_s:
                s = s._replace(spring_inc=build_spring_incidence(
                    s.springs, n, d_max=d_s))
                self.repadded[i] = True
            env.spec = s

    def _align_cluster_mm(self):
        """Re-pad every env's trimmed membership matrix to the batch-wide
        widest with inert rows (state.pad_cluster_matmul)."""
        widths = [e.spec.cluster_mm.matrix.shape[0] for e in self.envs
                  if e.spec.cluster_mm is not None]
        if not widths:
            return
        ct = max(widths)
        for i, env in enumerate(self.envs):
            mm = env.spec.cluster_mm
            if mm is not None and mm.matrix.shape[0] != ct:
                env.spec = env.spec._replace(
                    cluster_mm=pad_cluster_matmul(mm, ct))
                self.repadded[i] = True

    def _parked_plan(self, env):
        """The parked no-op: a short push far off, lifted PARKED_LIFT, with
        no attachment, the gripper open and the arm's links at rest."""
        plan = env.plan_push(PARKED_ACTION)
        plan["eef"] = plan["eef"] + PARKED_LIFT
        plan["attach_active"] = np.zeros_like(plan["attach_active"])
        plan["gap"] = np.full_like(plan["gap"], 0.4)
        if plan["link_pos"] is not None:
            t = len(plan["eef"])
            plan["link_pos"] = np.tile(env._rest_link_pos[None], (t, 1, 1))
            plan["link_quat"] = np.tile(env._rest_link_quat[None], (t, 1, 1))
        plan["t_push"] = 0
        return plan

    def run_pushes(self, actions):
        """One push per env in lockstep. actions: B actions (4,) in the
        action frame, or None for a parked no-op. Returns (positions at
        each chunk end (B, n_active, N, 3), the plans, the guard's flags
        (B,))."""
        t0 = time.perf_counter()
        e0 = self.envs[0]
        plans = [self._parked_plan(env) if act is None else env.plan_push(act)
                 for env, act in zip(self.envs, actions)]
        n_active = min(max(-(-(p["t_push"] + e0.settle_steps) // CHUNK)
                           for p in plans), e0.max_chunks)
        chunks = [env._chunked(env.max_chunks, p["eef"], p["rot"], p["gap"],
                               p["attach_active"], p["link_pos"],
                               p["link_quat"])
                  for env, p in zip(self.envs, plans)]
        # a host-side fact of the whole batch: only grasp pushes mutate
        # inv_mass mid-push
        has_attach = any(bool(np.any(c[5][:n_active])) for c in chunks)
        inputs = [env._push_inputs(env.state.shapes, *c, p["attach_idx"],
                                   p["attach_rel"], n_active, has_attach)
                  for env, c, p in zip(self.envs, chunks, plans)]
        g = max(1, e0.chunk_group)
        recs = [[] for _ in self.envs]
        bads = [[] for _ in self.envs]
        for lo in range(0, n_active, g):
            hi = min(lo + g, n_active)
            for i, env in enumerate(self.envs):
                env.state, rec, bad = env._push_group(
                    env.state, env.spec, lo, hi, *inputs[i])
                recs[i].append(rec)
                bads[i].append(bad)
        # the batch's only host sync: every env's records and guard flags
        pos_rec = torch.stack([torch.cat(r) for r in recs]).cpu().numpy()
        nan_any = torch.stack([torch.stack(b).any() for b in bads]).cpu().numpy()

        # per-env bookkeeping, as the lone push's plus the gripper's restore
        for i, env in enumerate(self.envs):
            if actions[i] is not None and plans[i]["q_final"] is not None:
                env._q_cur = plans[i]["q_final"]  # only a push that ran
            if env.gripper and actions[i] is not None:
                idx = torch.as_tensor(plans[i]["attach_idx"], device=env.device)
                p = env.state.particles
                w = p.inv_mass.index_put(
                    (idx,), _f32(env._inv_mass0[plans[i]["attach_idx"]],
                                 env.device))
                env.state = env.state._replace(particles=p._replace(inv_mass=w))
            eef_c, rot_c, gap_c, lp_c, lq_c, _ = chunks[i]
            env._gap_rec = gap_c[:n_active, -1]
            env._link_rec = (lp_c[:n_active, -1], lq_c[:n_active, -1])
            env._pad_recs = (eef_c[:n_active, -1], rot_c[:n_active, -1])
        self.stats = {"frames_per_env": n_active * CHUNK,
                      "seconds": time.perf_counter() - t0}
        return pos_rec, plans, nan_any

    def render_all(self):
        """One capture-view frame per env for the validity gate (B, R, R, 5)
        at GATE_RES: env 0's shape geometry posed by each env's shapes,
        the B envs as the frame axis of one render_frames_batch."""
        t0 = time.perf_counter()
        e0 = self.envs[0]
        res = self.GATE_RES
        scale = res / float(e0.screen[1])
        intr = np.asarray(e0.camera.intrinsics(), np.float32) * scale
        cam_pos, ang = e0.camera.single_view(e0.camera_view)
        dev = self.device
        sts = [e.state for e in self.envs]
        imgs = render_frames_batch(
            torch.stack([s.particles.pos for s in sts]), e0.colors,
            torch.stack([s.particles.active for s in sts]), sts[0].shapes,
            torch.stack([s.shapes.pos for s in sts]),
            torch.stack([s.shapes.quat for s in sts]),
            _f32(np.asarray(cam_pos, np.float32)[None], dev),
            _f32(_fwd_from_angle(ang)[None], dev), _f32(intr, dev),
            width=res, height=res, cloth_dims=e0._cloth_dims)
        out = imgs[:, 0].cpu().numpy()
        self.render_seconds = time.perf_counter() - t0
        return out

    def capture(self, i, pos_rec, plans, data):
        """Env i's captures on the lone env's contact-gated cadence, its
        n_active records padded with the last to max_chunks."""
        env = self.envs[i]
        eef_rec, rot_rec = env._pad_recs
        pads = env.max_chunks - pos_rec.shape[1]

        def pad(x):
            return np.concatenate([x, np.repeat(x[-1:], pads, 0)]) if pads else x

        env._gap_rec = pad(env._gap_rec)
        env._link_rec = tuple(pad(x) for x in env._link_rec)
        env._capture_push(data, pad(pos_rec[i]), pad(eef_rec), pad(rot_rec),
                          plans[i]["t_push"])


def color_diff_valid(img_before, img_after, thresh=0.01):
    """The reference's action-validity gate: the mean change of the capture
    view's uint8 colours above `thresh` (data_gen.py:86-94's rule at the
    configs' color_threshold; the renderer's colours are in [0, 1])."""
    a = (np.clip(img_after[..., :3], 0.0, 1.0) * 255).astype(np.uint8)
    b = (np.clip(img_before[..., :3], 0.0, 1.0) * 255).astype(np.uint8)
    d = np.abs(a.astype(np.float32) - b.astype(np.float32))
    return float(d.mean()) > thresh


def generate_batch(config, seeds, out_dir, n_timestep=None, device=None):
    """Generate len(seeds) episodes in lockstep with per-env retries,
    writing NN.npz a push (00 the settled scene). Returns the BatchSimEnv;
    its `episode_stats` holds each env's attempts a push, whether it got
    stuck, its actions and the batch's seconds."""
    d = config["dataset"]
    obj = d["obj"]
    n_timestep = n_timestep or int(d["n_timestep"])
    t0 = time.time()
    benv = BatchSimEnv(config, batch=len(seeds), device=device)
    benv.reset(seeds)
    b = len(seeds)
    epi_dirs = [os.path.join(out_dir, obj, f"{int(s):06}") for s in seeds]
    for env, epi_dir in zip(benv.envs, epi_dirs):
        os.makedirs(epi_dir, exist_ok=True)
        save_property_params(epi_dir, env.get_property_params())
        data = ([], [], [])
        env._store(data, store_tool_pose=env._parked_tool_pose())
        store_data(os.path.join(epi_dir, "00.npz"), data, np.zeros(4))
    cam_dir = os.path.join(out_dir, obj, "cameras")
    os.makedirs(cam_dir, exist_ok=True)
    np.save(os.path.join(cam_dir, "intrinsic.npy"),
            benv.envs[0].cam_intrinsic_params)
    np.save(os.path.join(cam_dir, "extrinsic.npy"),
            benv.envs[0].cam_extrinsic_matrix)

    grasp_state = [None] * b  # the cloth's boundary bookkeeping

    def sample(i):
        env = benv.envs[i]
        if obj == "cloth":
            init = grasp_state[i] is None
            bp, bd = (None, None) if init else grasp_state[i]
            act, bp, bd = env.sample_grasp_actions_corner(init, bp, bd)
            grasp_state[i] = (bp, bd)
            return act
        return env.sample_action()

    thresh = float(d.get("color_threshold", 0.01))
    # an env that exhausts MAX_RETRY is stuck for the rest of the episode:
    # a skipped push would leave a gap in the 01..NN numbering
    stuck = [False] * b
    attempts = [[] for _ in range(b)]
    actions_done = np.zeros((b, n_timestep, 4))
    for t in range(n_timestep):
        pending = [i for i in range(b) if not stuck[i]]
        if not pending:
            print(f"push {t + 1}/{n_timestep}: all envs stuck, stopping",
                  flush=True)
            break
        stored = [False] * b
        tries = [0] * b
        before = benv.render_all()
        for _ in range(MAX_RETRY):
            if not pending:
                break
            actions = [sample(i) if i in pending else None for i in range(b)]
            for i in pending:
                tries[i] += 1
            pos_rec, plans, nan_any = benv.run_pushes(actions)
            after = benv.render_all()
            next_pending = []
            for i in pending:
                if (actions[i] is None or nan_any[i]
                        or not color_diff_valid(before[i], after[i], thresh)):
                    next_pending.append(i)  # retry with a fresh action
                    continue
                data = ([], [], [])
                benv.envs[i]._eef_prev = None
                benv.capture(i, pos_rec, plans, data)
                store_data(os.path.join(epi_dirs[i], f"{t + 1:02}.npz"), data,
                           actions[i])
                actions_done[i, t] = actions[i]
                stored[i] = True
            pending = next_pending
        for i in pending:
            stuck[i] = True
            print(f"episode {int(seeds[i])} stuck at timestep {t} (no valid "
                  f"push after {MAX_RETRY} attempts)", flush=True)
        for i in range(b):
            attempts[i].append(tries[i])
        print(f"push {t + 1}/{n_timestep}: {sum(stored)}/{b} valid "
              f"({time.time() - t0:.0f}s)", flush=True)
    benv.episode_stats = {"attempts": attempts, "stuck": stuck,
                          "actions": actions_done,
                          "seconds": time.time() - t0}
    return benv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=str, default="data_gen/rope")
    ap.add_argument("--n-episode", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--base", type=int, default=0)
    ap.add_argument("--out", type=str, default="data/sim_data")
    ap.add_argument("--screen", type=int, default=0,
                    help="override screenWidth/Height (0: the config's)")
    ap.add_argument("--seeds", type=str, default="",
                    help="comma-separated episode seeds (overrides --base "
                         "and --n-episode; batched in --batch groups)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    config = load_config(args.config)
    if args.screen:
        config["dataset"]["screenWidth"] = args.screen
        config["dataset"]["screenHeight"] = args.screen
    if args.seeds:
        seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    else:
        seeds = list(range(args.base, args.base + args.n_episode))
    # a failed batch fails the run
    for lo in range(0, len(seeds), args.batch):
        generate_batch(config, seeds[lo:lo + args.batch], args.out,
                       device=args.device)


if __name__ == "__main__":
    main()
