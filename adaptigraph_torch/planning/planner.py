"""MPPI trajectory optimiser: the port of adaptigraph_tpu/planning/planner.py.

One sampled population per MPPI iteration: one batched rollout and one
reward evaluation (the rollout bounds its memory by `n_sample_chunk`).
Planner types: 'MPPI' (sample, roll out, softmax update, the best sample
tracked across iterations, optionally rolled out again alone) and 'GD'
(Adam ascent on the mean reward, autograd through the batched rollout).
`merge_res` is kept for callers that plan in chunks.

With a `mesh` (parallel/mesh.py's 1-D data mesh or 2-D data x model
mesh, one process a device) the population is split as JAX's shard_batch
splits it: every rank draws the whole population from the same noise,
rolls out its data row's rows, and the rollouts' outputs are gathered
over the data ranks in rank order, so every rank scores the whole
population. The reward's weight 2 / max(error) spans the population
(costs.assemble_reward), so the score needs every row; the rollout is
where the time goes. Every rank then takes the same MPPI update and the
same argmax. GD steps each rank's rows with its own Adam (Adam is
elementwise) on the gradient of the whole population's mean reward. A
population the whole mesh does not divide is rolled out whole on every
rank, as JAX replicates it.

Spans (utils/profiling): `plan.call` around trajectory_optimization,
`plan.iteration` around each MPPI iteration and `plan.score` around each
call of the evaluator, tagged with the population it scores.
"""

from __future__ import annotations

import numpy as np
import torch

from adaptigraph_torch.parallel.mesh import (check_data_mesh, data_rank,
                                             gather, gather_rows, local_rows)
from adaptigraph_torch.planning.actions import (clip_actions,
                                                draw_action_noise,
                                                optimize_action_mppi,
                                                sample_action_seq)
from adaptigraph_torch.utils import profiling
from adaptigraph_torch.utils.device import resolve_device


class Planner:
    """config keys: action_dim, model_rollout_fn, evaluate_traj_fn,
    n_sample, n_look_ahead, n_update_iter, reward_weight, action_lower_lim,
    action_upper_lim, planner_type; optional noise_level, push_length,
    rollout_best, lr, verbose, device (CUDA unless given), noise_fn and
    mesh (a 1-D ('data',) mesh from parallel.mesh.make_mesh or a 2-D
    ('data', 'model') mesh from make_mesh_2d; every rank builds the same
    Planner and calls it alike).

    noise_fn(iter_index, n_sample, n_look, adim) returns the draws of
    `sample_action_seq` for that iteration (GD draws iteration 0's once).
    When it is absent, the draws come from a torch.Generator on the device,
    seeded with the `seed` given to trajectory_optimization."""

    def __init__(self, config):
        self.mesh = config.get("mesh")
        if self.mesh is not None:
            check_data_mesh(self.mesh)
        self.cfg = config
        self.device = resolve_device(config.get("device"))
        self.model_rollout = config["model_rollout_fn"]
        self.evaluate_traj = config["evaluate_traj_fn"]
        self.n_sample = int(config["n_sample"])
        self.n_look_ahead = int(config["n_look_ahead"])
        self.n_update_iter = int(config["n_update_iter"])
        self.reward_weight = float(config["reward_weight"])
        self.lower = torch.as_tensor(np.asarray(config["action_lower_lim"]),
                                     dtype=torch.float32, device=self.device)
        self.upper = torch.as_tensor(np.asarray(config["action_upper_lim"]),
                                     dtype=torch.float32, device=self.device)
        self.planner_type = config.get("planner_type", "MPPI")
        self.noise_level = float(config.get("noise_level", 0.3))
        self.push_length = float(config.get("push_length", 0.10))
        self.rollout_best = bool(config.get("rollout_best", True))
        self.lr = float(config.get("lr", 1e-3))
        self.verbose = bool(config.get("verbose", False))
        self.noise_fn = config.get("noise_fn")

    def _noise(self, seed: int):
        if self.noise_fn is not None:
            return self.noise_fn
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def draw(i, n_sample, n_look, adim):
            return draw_action_noise(n_sample, n_look, adim, i, gen)
        return draw

    def trajectory_optimization(self, state_cur, act_seq, seed: int = 0):
        act_seq = torch.as_tensor(act_seq, dtype=torch.float32,
                                  device=self.device)
        noise = self._noise(seed)
        if self.planner_type not in ("MPPI", "GD"):
            raise ValueError(f"unknown planner type {self.planner_type}")
        with profiling.span("plan.call"):
            if self.planner_type == "MPPI":
                return self._mppi(state_cur, act_seq, noise)
            return self._gd(state_cur, act_seq, noise)

    def _sample(self, act_seq, noise, i):
        n_look, adim = act_seq.shape
        draws = noise(i, self.n_sample, n_look, adim)
        return sample_action_seq(act_seq, self.lower, self.upper,
                                 self.n_sample, draws, iter_index=i,
                                 noise_level=self.noise_level,
                                 push_length=self.push_length)

    def _rows(self):
        """This rank's rows of the population; None when it is whole."""
        if self.mesh is None:
            return None
        return local_rows(self.n_sample, self.mesh)

    def _score(self, state_cur, own, rows, acts=None):
        """(model_out, eval_out) of the whole population: the rollout of
        `own`, this rank's `rows` of it (the whole population when rows is
        None), gathered from every rank in rank order with this rank's own
        tensors (and any gradient they carry) in its place, then scored
        with `acts`, the whole population (gathered from `own` when
        None)."""
        model_out = self.model_rollout(state_cur, own)
        if rows is not None:
            model_out = self._gathered(model_out, own.shape[0])
            if acts is None:
                acts = self._gathered({"a": own}, own.shape[0])["a"]
        acts = own if acts is None else acts
        return model_out, self._evaluate(model_out, acts, state_cur)

    def _evaluate(self, model_out, acts, state_cur):
        with profiling.span("plan.score", acts.shape[0]):
            return self.evaluate_traj(model_out["state_seqs"], acts,
                                      state_cur=state_cur)

    def _gathered(self, out, n):
        whole = dict(out)
        for k, v in out.items():
            if torch.is_tensor(v) and v.ndim and v.shape[0] == n:
                parts = gather(v.detach(), self.mesh)
                parts[data_rank(self.mesh)] = v
                whole[k] = torch.cat(parts)
        return whole

    def _best(self, state_cur, act_seq):
        if not self.rollout_best:
            return None, None
        model_out = self.model_rollout(state_cur, act_seq[None])
        return model_out, self._evaluate(model_out, act_seq[None], state_cur)

    @torch.no_grad()
    def _mppi(self, state_cur, act_seq, noise):
        best_act, best_reward = None, -float("inf")
        model_outputs, eval_outputs = [], []
        rows = self._rows()
        for i in range(self.n_update_iter):
            with profiling.span("plan.iteration", i):
                act_seqs = self._sample(act_seq, noise, i)
                own = act_seqs if rows is None else act_seqs[rows]
                model_out, eval_out = self._score(state_cur, own, rows,
                                                  act_seqs)
                rewards = eval_out["reward_seqs"]
                act_seq = optimize_action_mppi(act_seqs, rewards,
                                               self.reward_weight, self.lower,
                                               self.upper, self.push_length)
                bi = int(torch.argmax(rewards))  # the first index on ties
                if best_act is None or float(rewards[bi]) > best_reward:
                    best_act = act_seqs[bi]
                    best_reward = float(rewards[bi])
            if self.verbose:
                model_outputs.append(model_out)
                eval_outputs.append(eval_out)
        best_model_out, best_eval_out = self._best(state_cur, best_act)
        return {"act_seq": best_act,
                "model_outputs": model_outputs if self.verbose else None,
                "eval_outputs": eval_outputs if self.verbose else None,
                "best_model_output": best_model_out,
                "best_eval_output": best_eval_out}

    def _gd(self, state_cur, act_seq, noise):
        rows = self._rows()
        act_seqs = self._sample(act_seq, noise, 0)
        if rows is not None:
            act_seqs = act_seqs[rows]
        act_seqs = act_seqs.clone().requires_grad_(True)
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8, bias-corrected
        opt = torch.optim.Adam([act_seqs], lr=self.lr, betas=(0.9, 0.999),
                               eps=1e-8)
        for _ in range(self.n_update_iter):
            opt.zero_grad()
            _, ev = self._score(state_cur, act_seqs, rows)
            (-ev["reward_seqs"].mean()).backward()
            opt.step()
            with torch.no_grad():
                act_seqs.copy_(clip_actions(act_seqs, self.lower, self.upper))
        with torch.no_grad():
            own = act_seqs.detach()
            act_seqs = own if rows is None else gather_rows(own, self.mesh)
            _, ev = self._score(state_cur, own, rows, act_seqs)
            act_seq = act_seqs[int(torch.argmax(ev["reward_seqs"]))]
            best_model_out, best_eval_out = self._best(state_cur, act_seq)
        return {"act_seq": act_seq, "model_outputs": None,
                "eval_outputs": None, "best_model_output": best_model_out,
                "best_eval_output": best_eval_out}

    def merge_res(self, res_list):
        """The result whose best action's mean reward is highest."""
        rewards = [float(r["best_eval_output"]["reward_seqs"].mean())
                   for r in res_list]
        return res_list[int(np.argmax(rewards))]
