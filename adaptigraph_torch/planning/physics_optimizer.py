"""Online physics-parameter estimation ("PPO" in the reference's naming:
physics parameter optimisation, not RL): the port of
adaptigraph_tpu/planning/physics_optimizer.py.

Keep a normalised physics-parameter estimate (0.5 at first). After each
interaction, replay every logged (state_init, action, state_real) triple
through the batched masked rollout under candidate parameters and minimise
the mean masked chamfer error: GP-EI for a 1-D parameter, CMA-ES
otherwise, in the box [-0.2, 1.2], never taking a candidate worse than the
incumbent; then clamp the estimate. The replay runs on the device; the GP
and CMA-ES bookkeeping is host numpy.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from adaptigraph_torch.ops.losses import masked_chamfer
from adaptigraph_torch.planning.forward_dynamics import make_masked_replay
from adaptigraph_torch.planning.optim import CMAES, gp_minimize_ei
from adaptigraph_torch.utils.device import resolve_device


class PhysicsParamOnlineOptimizer:
    """The estimate of `material`'s physics parameter, refined from the
    interactions logged in `save_dir`; `params` is a state_dict of
    `model`, and the replay runs on `device` (CUDA unless given).

    Kept as the JAX package has it (physics_optimizer.py:41-48), for
    parity: the estimate is seeded from the numerically latest `ppo_*.npz`
    already in save_dir, however stale (a refit of an earlier run), and a
    file whose name does not parse as `ppo_<int>.npz` makes the
    constructor raise ValueError."""

    def __init__(self, task_config, model, params, material, save_dir,
                 device=None):
        self.device = resolve_device(device)
        self.task_config = task_config
        self.model = model
        self.params = params
        self.material = material
        self.save_dir = save_dir
        self.material_dims = task_config["material_dims"]
        self.dim = int(self.material_dims[material])
        self.physics_param = {material: np.full(self.dim, 0.5, np.float32)}
        ppo_files = sorted(
            glob.glob(os.path.join(save_dir, "ppo_*.npz")),
            key=lambda p: int(os.path.basename(p)[4:-4]))
        if ppo_files:
            est = np.asarray(np.load(ppo_files[-1])["physics_param"],
                             np.float32).reshape(-1)
            if est.size == self.dim:
                self.physics_param[material] = np.clip(est, -0.2, 1.2)
        self.replay = make_masked_replay(model, task_config)

    # ---------- logging ----------

    def log_interaction(self, i, act, state_init, state_pred, state_real):
        np.savez(os.path.join(self.save_dir, f"interaction_{i:03}.npz"),
                 act=act, state_init=state_init, state_pred=state_pred,
                 state_real=state_real)

    def _load_interactions(self):
        files = sorted(glob.glob(os.path.join(self.save_dir,
                                              "interaction_*.npz")))
        acts, inits, reals = [], [], []
        for f in files:
            d = np.load(f)
            acts.append(d["act"])
            inits.append(d["state_init"])
            reals.append(d["state_real"])
        return acts, inits, reals

    # ---------- objective ----------

    def dynamics_error(self, physics_param, acts, state_init_list,
                       state_real_list):
        """The mean masked chamfer between the replayed and the real final
        states."""
        max_nobj = int(self.task_config["max_nobj"])
        b = len(acts)
        init = np.zeros((b, max_nobj, 3), np.float32)
        real = np.zeros((b, max_nobj, 3), np.float32)
        init_mask = np.zeros((b, max_nobj), bool)
        real_mask = np.zeros((b, max_nobj), bool)
        for i in range(b):
            si, sr = state_init_list[i], state_real_list[i]
            init[i, : len(si)] = si
            real[i, : len(sr)] = sr
            init_mask[i, : len(si)] = True
            real_mask[i, : len(sr)] = True
        pp = np.tile(np.asarray(physics_param, np.float32).reshape(1, -1),
                     (b, 1))

        def on(a):
            return torch.as_tensor(a, device=self.device)

        with torch.no_grad():
            out = self.replay(self.params, on(init), on(init_mask),
                              on(np.stack(acts).astype(np.float32)), on(pp))
            err = masked_chamfer(out["state_seqs"], on(real), on(init_mask),
                                 on(real_mask))
        return float(err.mean())

    # ---------- optimisation ----------

    def optimize(self, i, iterations: int = 50):
        acts, inits, reals = self._load_interactions()
        if len(acts) != i + 1:
            raise ValueError(f"expected {i + 1} interactions in "
                             f"{self.save_dir}, found {len(acts)}")

        init_error = self.dynamics_error(self.physics_param[self.material],
                                         acts, inits, reals)
        print(f"init error {init_error:.5f}")

        def obj(x):
            return self.dynamics_error(x, acts, inits, reals)

        if self.dim == 1:
            res = gp_minimize_ei(obj, [(-0.2, 1.2)] * self.dim,
                                 n_calls=iterations,
                                 n_initial=min(20, iterations),
                                 noise_level=0.2 * init_error + 1e-6)
            # pick by the replay error itself, not the GP posterior alone:
            # on a flat posterior the expected minimum can be worse than the
            # best observation, and the objective is deterministic
            exp_x = np.atleast_1d(res["expected_x"]).astype(np.float32)
            cands = [(exp_x, float(obj(exp_x))),
                     (np.atleast_1d(res["x"]).astype(np.float32),
                      float(res["fun"]))]
            ppm, error = min(cands, key=lambda c: c[1])
        else:
            es = CMAES(self.physics_param[self.material].astype(np.float64),
                       sigma=0.2, bounds=(-0.2, 1.2))
            ppm, error = es.optimize(obj, iterations=max(1, iterations // es.lam))
            ppm = np.asarray(ppm, np.float32)

        if error > init_error:
            # never regress the incumbent estimate
            ppm = np.asarray(self.physics_param[self.material],
                             np.float32).copy()
            error = init_error
        print(f"new physics param {ppm} (error {error:.5f})")
        self.physics_param[self.material] = np.clip(ppm, -0.2, 1.2)
        np.savez(os.path.join(self.save_dir, f"ppo_{i}.npz"),
                 physics_param=ppm, error=error, error_init=init_error)
        return ppm, error, init_error
