"""Episode generation: the port of adaptigraph_tpu/sim/data_gen.py.

Per episode: seed with the episode index, reset, then up to n_timestep
pushes, each retried up to 10 times until the rendered image changes by
color_threshold (the reference's data_gen.py:64-105). With --save it
writes one `NN.npz` a push (00 the settled scene; sim/episode_io.py),
property_params.pkl, a resume state after each push, and the cameras'
intrinsic.npy / extrinsic.npy for the base episode.

Usage:
  python -m adaptigraph_torch.sim.data_gen --config data_gen/rope --save \\
      [--base 0] [--n-episode 5] [--out DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from adaptigraph_torch.sim.env import SimEnv
from adaptigraph_torch.sim.episode_io import save_property_params, store_data
from adaptigraph_torch.utils import load_config

_RESUME_FILE = "resume_state.npz"


def _np(x):
    return x.detach().cpu().numpy()


def _save_resume_state(env: SimEnv, epi_dir: str, t_next: int):
    """Checkpoint the scene's dynamic state after a stored push, so a killed
    process resumes the episode at push granularity."""
    st = env.state
    extra = {}
    if st.cluster_rest is not None:
        extra["cl_rest"] = _np(st.cluster_rest)
    np.savez(os.path.join(epi_dir, _RESUME_FILE), t_next=t_next,
             pos=_np(st.particles.pos), vel=_np(st.particles.vel),
             inv_mass=_np(st.particles.inv_mass),
             s_pos=_np(st.shapes.pos), s_quat=_np(st.shapes.quat),
             s_ppos=_np(st.shapes.prev_pos), s_pquat=_np(st.shapes.prev_quat),
             cl_rot=_np(st.cluster_rot), gl_rot=_np(st.global_rot),
             sampled_idx=np.asarray(env.sampled_idx), **extra)


def _load_resume_state(env: SimEnv, epi_dir: str) -> int:
    """Restore a `_save_resume_state` checkpoint into a freshly reset env
    (same seed => same scene build). Returns the next push index, or 0
    when the checkpoint was written under other capacity caps."""
    z = np.load(os.path.join(epi_dir, _RESUME_FILE))
    st = env.state
    if z["pos"].shape != tuple(st.particles.pos.shape):
        return 0

    def t(key):
        return torch.as_tensor(z[key], device=env.device)

    p = st.particles._replace(pos=t("pos"), vel=t("vel"),
                              inv_mass=t("inv_mass"))
    sh = st.shapes._replace(pos=t("s_pos"), quat=t("s_quat"),
                            prev_pos=t("s_ppos"), prev_quat=t("s_pquat"))
    env.state = st._replace(particles=p, shapes=sh, cluster_rot=t("cl_rot"),
                            global_rot=t("gl_rot"),
                            cluster_rest=(t("cl_rest") if "cl_rest" in z
                                          else None))
    env.sampled_idx = np.asarray(z["sampled_idx"])
    env._eef_prev = None
    return int(z["t_next"])


def gen_episode(config, idx_episode: int, save_data: bool, data_dir: str,
                env: SimEnv | None = None, resume: bool = False, device=None):
    """Generate one episode (with `env`, or a new SimEnv on `device`).
    Returns the env; `env.episode_stats` holds the pushes run (retries
    included) and the wall seconds."""
    t0 = time.time()
    d = config["dataset"]
    obj = d["obj"]
    n_timestep = int(d["n_timestep"])
    color_threshold = float(d.get("color_threshold", 0.01))

    epi_dir = os.path.join(data_dir, obj, f"{idx_episode:06}")
    if save_data:
        os.makedirs(epi_dir, exist_ok=True)

    env = env or SimEnv(config, device=device)
    t_start = 0
    resumable = (resume and save_data
                 and os.path.exists(os.path.join(epi_dir, _RESUME_FILE))
                 and os.path.exists(os.path.join(epi_dir, "00.npz")))
    if resumable:
        # rebuild the scene (same seed), skip the settle, restore the
        # checkpointed post-push state
        env.reset(seed=idx_episode, save_data=False, settle=False)
        env.finish_reset(save_data=False)
        t_start = _load_resume_state(env, epi_dir)
        props = env.get_property_params()
        print(f"Episode {idx_episode} RESUME at push {t_start}", flush=True)
        data = None
    else:
        data = env.reset(seed=idx_episode, save_data=save_data)
        props = env.get_property_params()
    print(f"Episode {idx_episode} physics params: {props}")

    actions = np.zeros((n_timestep, 4))
    if save_data and not resumable:
        store_data(os.path.join(epi_dir, f"{0:02}.npz"), data, actions[0])
        save_property_params(epi_dir, props)
        if idx_episode == int(d.get("base", 0)):
            cam_dir = os.path.join(data_dir, obj, "cameras")
            os.makedirs(cam_dir, exist_ok=True)
            np.save(os.path.join(cam_dir, "intrinsic.npy"),
                    env.cam_intrinsic_params)
            np.save(os.path.join(cam_dir, "extrinsic.npy"),
                    env.cam_extrinsic_matrix)

    img = env.render()
    last_img = img.copy()
    stuck = False
    pushes_run = 0
    boundary_points = boundary = None
    for t in range(t_start, n_timestep):
        data = ([], [], [])
        for k in range(10):
            if obj == "cloth":
                if t == 0 and k == 0:
                    u, boundary_points, boundary = env.sample_action(init=True)
                else:
                    u, boundary_points, boundary = env.sample_action(
                        boundary_points=boundary_points, boundary=boundary)
            else:
                u = env.sample_action()
            if u is None:
                stuck = True
                print(f"Episode {idx_episode} timestep {t}: no valid action found")
                break
            out = env.step(u, save_data, data)
            pushes_run += 1
            if out is None:  # NaN explosion guard (flex_env.py:379-381)
                stuck = True
                break
            img, data = out
            color_diff = float(np.mean(np.abs(img[..., :3] - last_img[..., :3])))
            if color_diff < color_threshold:
                data = ([], [], [])
                if k == 9:
                    stuck = True
                    print(f"episode {idx_episode} stuck at timestep {t}")
            else:
                break
        if stuck:
            break
        actions[t] = u
        last_img = img.copy()
        if save_data:
            store_data(os.path.join(epi_dir, f"{t + 1:02}.npz"), data, actions[t])
            _save_resume_state(env, epi_dir, t + 1)
            print(f"episode {idx_episode} timestep {t} done "
                  f"({len(data[1])} captured frames)", flush=True)
    seconds = time.time() - t0
    env.episode_stats = {"pushes_run": pushes_run, "stuck": stuck,
                         "actions": actions, "seconds": seconds}
    print(f"Episode {idx_episode} time: {seconds:.1f}s", flush=True)
    return env


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default="data_gen/rope")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--base", type=int, default=None)
    ap.add_argument("--n-episode", type=int, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: CUDA; 'cpu' to run there)")
    args = ap.parse_args(argv)

    config = load_config(args.config)
    d = config["dataset"]
    base = args.base if args.base is not None else int(d.get("base", 0))
    n_episode = args.n_episode if args.n_episode is not None else int(d["n_episode"])
    data_dir = args.out or d["folder"]
    os.makedirs(data_dir, exist_ok=True)

    env = None
    for epi in range(base, base + n_episode):
        env = gen_episode(config, epi, args.save, data_dir, env=env,
                          device=args.device)


if __name__ == "__main__":
    main()
