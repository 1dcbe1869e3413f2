"""The MPPI planning driver: the port's Planner, as plan.py composes it for
one action, planning a push of the configuration's object.

Set-up: the model with the run's seeded weights, the perceived state (the
configuration's own scene, the same in every run) and the target, the
population rollout (planning.forward_dynamics), the evaluator composed
from planning.costs (chunked_cost with the task's error, penalty and
workspace), and a Planner drawing its randoms from the harness's own
generator through `noise_fn`. The warm-up plans once with a population of
one chunk. The window calls trajectory_optimization back to back from the
same state, each call `n_update_iter` MPPI iterations over the published
population, and closes at the end of the call in progress.

The check, once the window has closed, covers every call of the window:
each iteration's whole population against the reference's sampling from
the same draws (the incumbent from the reference's MPPI update of the
program's rewards), the returned action against the reference's choice
over the program's rewards, and for a sample of rows drawn from the seed
(the longest pushes among them) the predicted states and the rewards
against the reference's own rollout and reward of the same pushes, and
the rewards against the reference's reward of the program's own states.
The rollout is judged by the states and the cost by the last: the reward
gap itself is printed, not compared, since the penalties' exp(-100 d)
terms scale a state's rounding by up to 500 in rows at the workspace's
side.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from harness import inputs
from harness.flops import forward_flops, share_of_peak
from harness.precision import matmul_precision
from harness.trace import host_span
from reference import model as ref_model
from reference import planning as ref_plan

UNIT = "samples/s"


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans,
                 sizes: dict | None = None):
        from adaptigraph_torch.dynamics.model import (DynamicsPredictor,
                                                      model_config_from_yaml)
        from adaptigraph_torch.planning.costs import (PENALTIES, chunked_cost,
                                                      make_error_fn)
        from adaptigraph_torch.planning.forward_dynamics import (
            make_batched_dynamics)
        from adaptigraph_torch.planning.planner import Planner

        sizes = sizes or {}
        self.seed, self.dev, self.spans = seed, device, spans
        pub = cfg["published"]
        tc = dict(pub["planning"], **sizes.get("task", {}))
        dyn = pub["dynamics"]
        self.tc, self.dyn = tc, dyn
        self.n_sample = int(tc["n_sample"])
        self.chunk = int(tc["n_sample_chunk"])
        self.iters = int(traffic["n_update_iter"])
        self.rows = int(sizes.get("checked_rows", traffic["checked_rows"]))
        self.longest = int(sizes.get("longest_rows", traffic["longest_rows"]))
        phys_dim = int(tc["material_dims"][tc["material"]])
        n_his = int(dyn["dataset_config"]["n_his"])
        self.widths = ref_model.widths(dyn["model_config"], n_his, phys_dim)
        shapes = ref_model.layer_shapes(*self.widths)

        self.weights = inputs.weights(shapes, cfg["assumed"]["weights"], seed,
                                      device)
        scene = cfg["assumed"]["object"]
        self.state, self.mask = inputs.planning_state(scene, tc, device)
        self.scene = {"scene_seed": scene["scene_seed"],
                      "perceived": int(self.mask.sum()),
                      "state_sha256": hashlib.sha256(
                          self.state.cpu().numpy().tobytes()).hexdigest()}
        self.target = inputs.planning_target(
            seed, self.state, self.mask, tc, cfg["assumed"].get("target", {}),
            device)
        self.phys = torch.full((phys_dim,), float(cfg["physics_param"]),
                               device=device)

        mc = model_config_from_yaml(dyn["model_config"], dyn["dataset_config"],
                                    phys_dim)
        self.mode = (mc.aggregation,
                     str(mc.compute_dtype).replace("torch.", ""))
        model = DynamicsPredictor(mc, device=device)
        model.load_state_dict(self.weights, strict=True)
        self.model = model.eval()
        params = dict(model.state_dict())
        rollout = make_batched_dynamics(model, tc)

        if tc["target_type"] == "box":
            err = make_error_fn(tc, target_box=self.target, device=device)
        else:
            err = make_error_fn(tc, target_state=self.target, device=device)
        pen = PENALTIES[tc["penalty_type"]]
        r = float(tc["sim_real_ratio"])
        b = tc["bbox"]
        bbox = torch.tensor([[b[0] * r, b[3] * r], [b[2] * r, b[5] * r]],
                            device=device)
        self.record = None  # the window's populations, when recording

        def model_rollout(state_cur, acts):
            with host_span("rollout"):
                return rollout(params, self.state, self.mask, acts, self.phys)

        def evaluate(state_seqs, acts, state_cur=None, **kw):
            n = acts.shape[0]
            with host_span("cost"), spans.span("cost", n):
                out = chunked_cost(state_seqs, acts, self.state, err, pen,
                                   bbox, obj_mask=self.mask,
                                   n_chunk=self.chunk)
            if self.record is not None and n == self.n_sample:
                self.record["pops"].append((acts, state_seqs,
                                            out["reward_seqs"]))
            return out

        def planner(n_sample, noise_fn):
            return Planner({
                "action_dim": 4, "model_rollout_fn": model_rollout,
                "evaluate_traj_fn": evaluate, "n_sample": n_sample,
                "n_look_ahead": int(traffic["n_look_ahead"]),
                "n_update_iter": self.iters,
                "reward_weight": float(tc["reward_weight"]),
                "action_lower_lim": np.asarray(tc["action_lower_lim"],
                                               np.float32),
                "action_upper_lim": np.asarray(tc["action_upper_lim"],
                                               np.float32),
                "planner_type": "MPPI",
                "noise_level": float(tc["noise_level"]),
                "push_length": float(tc["push_length"]), "device": device,
                "noise_fn": noise_fn})

        self._planner = planner
        self.init_act = np.tile(np.array(
            [[-1.0, 0.0, 0.0, float(tc["action_lower_lim"][3])]], np.float32),
            (int(traffic["n_look_ahead"]), 1))
        self.warm_gen = inputs.generator(seed, "warmup", device)
        self.noise_gen = inputs.generator(seed, "noise", device)

    def _noise(self, gen, log):
        def draw(i, n_sample, n_look, adim):
            if i == 0:
                d = torch.rand((n_sample, n_look, adim), generator=gen,
                               device=self.dev)
            else:
                d = torch.randn((n_look, n_sample, 4), generator=gen,
                                device=self.dev)
            if log is not None:
                log.append(d)
            return d
        return draw

    def warm_up(self):
        """One planning call over a population of one chunk: every shape
        the window uses (the chunk's rollout and score, the single-sample
        rollout of the best push)."""
        p = self._planner(self.chunk, self._noise(self.warm_gen, None))
        p.trajectory_optimization(self.state, self.init_act)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _hooks(self):
        """Spans on the model's forward and on the edge rebuild."""
        import adaptigraph_torch.planning.forward_dynamics as fd
        spans = self.spans
        h1 = self.model.register_forward_pre_hook(
            lambda m, a: spans.start("forward"))
        h2 = self.model.register_forward_hook(
            lambda m, a, o: spans.stop("forward", a[0].shape[0]))
        build = fd.build_edges_slotted_batch

        def edges(states, *a, **k):
            with host_span("edges"), spans.span("edges", states.shape[0]):
                return build(states, *a, **k)
        fd.build_edges_slotted_batch = edges

        def undo():
            h1.remove()
            h2.remove()
            fd.build_edges_slotted_batch = build
        return undo

    def window(self, seconds: float, profiled=None) -> dict:
        draws = []
        planner = self._planner(self.n_sample, self._noise(self.noise_gen,
                                                           draws))
        self.record = {"pops": [], "answers": [], "draws": draws}
        undo = self._hooks() if self.spans.enabled else None
        calls = 0
        t0 = time.perf_counter()
        while True:
            if profiled is not None and calls == 0:
                with profiled:
                    res = planner.trajectory_optimization(self.state,
                                                          self.init_act)
            else:
                res = planner.trajectory_optimization(self.state,
                                                      self.init_act)
            self.record["answers"].append(res["act_seq"])
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if undo is not None:
            undo()
        self.calls = calls
        return {"wall_s": wall, "calls": calls,
                "attempted": calls * self.iters * self.n_sample}

    def end_to_end(self, w: dict) -> dict:
        return {"mppi_samples_per_s": (w["attempted"] / w["wall_s"], UNIT)}

    def free(self):
        """Drop the program's model and closures; keep what it produced."""
        self.model = None
        self._planner = None

    def check(self, stand_in=None) -> dict:
        """The compared numbers. `stand_in`, for the control, replaces the
        program's states and rewards of the checked rows by its own (the
        program's population is still read for the largest error)."""
        task = ref_plan.Task(self.tc, self.dyn, self.dev)
        rec = self.record
        g = inputs.generator(self.seed, "rows", self.dev)
        act_gap = best_gap = 0.0
        state_gaps, reward_gaps, cost_gaps = [], [], []
        counts = {"forwards": 0, "nodes": 0, "edges": 0}
        forwards_needed = 0
        self.worst = (0.0, None)  # the widest row gap and its edge margin
        for c in range(self.calls):
            pops = rec["pops"][c * self.iters:(c + 1) * self.iters]
            d = rec["draws"][c * self.iters:(c + 1) * self.iters]
            incumbent = torch.as_tensor(self.init_act, device=self.dev)
            ref_acts = []
            for it, (acts, seqs, rewards) in enumerate(pops):
                a = ref_plan.sample(incumbent, task.lower, task.upper,
                                    self.n_sample, d[it], it,
                                    task.noise_level, task.push_length)
                ref_acts.append(a)
                act_gap = max(act_gap, float((acts - a).abs().max()))
                incumbent = ref_plan.mppi_update(
                    a, rewards, task.reward_weight, task.lower, task.upper,
                    task.push_length)
                reps = a[:, :, 3].to(torch.int32).sum(1)
                forwards_needed += int(reps.sum())
                largest = ref_plan.largest_error(task, seqs, self.mask,
                                                 self.target)
                longest, rest = self._rows(g, reps)
                for rows, n in ((longest, None), (rest, counts)):
                    sg, rg, cg = self._rollout_gaps(task, a, seqs, rewards,
                                                    rows, largest, n,
                                                    stand_in)
                    state_gaps.append(sg)
                    reward_gaps.append(rg)
                    cost_gaps.append(cg)
            best = ref_plan.best_action(ref_acts, [p[2] for p in pops])
            answer = rec["answers"][c]
            best_gap = max(best_gap, float((answer - best).abs().max()))
            forwards_needed += int(best[:, 3].to(torch.int32).sum())
        self.counts = counts
        self.forwards_needed = forwards_needed
        out = {"act_gap": act_gap, "best_gap": best_gap,
               "cost_gap": float(torch.cat(cost_gaps).max()),
               "widest_row_edge_margin": self.worst[1]}
        for name, gaps in (("state_gap", torch.cat(state_gaps)),
                           ("reward_gap", torch.cat(reward_gaps))):
            out.update({name: float(gaps.max()),
                        name + "_p90": float(torch.quantile(gaps.double(),
                                                            0.9))})
        return out

    def _rows(self, g, reps):
        """The checked rows: `longest` of the longest pushes, the rest
        uniform over the population, drawn from the run's seed."""
        n = reps.shape[0]
        perm = torch.randperm(n, generator=g, device=self.dev)
        longest = perm[reps[perm] == reps.max()][:self.longest]
        rest = perm[~torch.isin(perm, longest)][:self.rows - longest.numel()]
        return longest, rest

    def _rollout_gaps(self, task, acts, seqs, rewards, rows, largest, counts,
                      stand_in):
        """Per-row widest state gap, reward gap and cost gap of `rows`
        (the last: the program's reward against the reference's reward of
        the program's own states); `counts` (when given) gathers the valid
        nodes and edges of their forwards."""
        s_gaps, r_gaps, c_gaps = [], [], []
        for i in range(0, rows.numel(), 256):
            r = rows[i:i + 256]
            ref = ref_plan.rollout(self.weights, task, self.state, self.mask,
                                   acts[r], self.phys, counts=counts)
            parts = ref_plan.reward_parts(task, ref, acts[r], self.state,
                                          self.mask, self.target)
            ref_r = ref_plan.reward(parts, largest)
            got_s = seqs[r] if stand_in is None else stand_in(task, acts[r])
            cost = ref_plan.reward(ref_plan.reward_parts(
                task, got_s, acts[r], self.state, self.mask, self.target),
                largest)
            got_r = rewards[r] if stand_in is None else cost
            s_gaps.append((got_s - ref).abs().amax(dim=(1, 2, 3)))
            r_gaps.append((got_r - ref_r).abs())
            c_gaps.append((got_r - cost).abs())
        s_gaps, r_gaps = torch.cat(s_gaps), torch.cat(r_gaps)
        worst = int(torch.argmax(s_gaps))
        if float(s_gaps[worst]) > self.worst[0]:
            m = torch.full((1,), 1e10, device=self.dev)
            ref_plan.rollout(self.weights, task, self.state, self.mask,
                             acts[rows[worst:worst + 1]], self.phys, margins=m)
            self.worst = (float(s_gaps[worst]), float(m[0]))
        return s_gaps, r_gaps, torch.cat(c_gaps)

    def control(self, precision: str):
        """The stand-in for the control: the reference's rollout at
        `precision` (on the card, "tf32" turns the card's TF32 on)."""
        def stand_in(task, acts):
            with matmul_precision(precision):
                return ref_plan.rollout(self.weights, task, self.state,
                                        self.mask, acts, self.phys,
                                        precision=precision)
        return stand_in

    def flops(self) -> float:
        """The model's operations in the window: every forward a push
        needs (each sample's own repeats, and the best push's), at the
        checked rows' mean of valid nodes and edges a forward."""
        c = self.counts
        if not c["forwards"]:
            return 0.0
        nodes = c["nodes"] / c["forwards"]
        edges = c["edges"] / c["forwards"]
        objects = float(self.mask.sum())
        nf, p_in, r_in = self.widths
        per = forward_flops(nodes, objects, edges, nf, p_in, r_in,
                            int(self.dyn["model_config"]["pstep"]))
        return per * self.forwards_needed

    def mfu(self, wall_s: float) -> float:
        return share_of_peak(self.flops(), wall_s, "float32")
