"""The dynamics-training driver: the port's device-resident K-step train
chunk (dynamics.train.make_train_chunk) over seeded episodes held on the
device, as train() runs it.

Set-up: the model with the run's seeded weights, Adam at the published
learning rate (dynamics.train.make_optimizer), the episodes and their
frame windows on the device, a graph generator seeded from the run's seed,
and one chunk: the first K steps, on index rows that all differ. Those
steps go through the same chunk call as the window's; the optimizer's
state after step 1 and the parameters after step 3 are copied aside by
optimizer hooks, which are then removed. The window runs further chunks
back to back, on index tables drawn from the seed as train() draws them,
and closes at the end of the chunk in progress.

The check follows the first three steps in the reference, from the same
weights, windows and graph draws: each step's loss, the first gradient as
Adam got it (its first moment after step 1, over 1 - beta1) and the
parameters' change after three steps, each per leaf.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from harness import inputs
from harness.flops import forward_flops, share_of_peak
from harness.precision import matmul_precision
from harness.trace import host_span
from reference import model as ref_model
from reference import training as ref_train

UNIT = "samples/s"
FOLLOWED = 3  # the steps the reference follows


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, spans,
                 sizes: dict | None = None):
        from adaptigraph_torch.dynamics.model import (DynamicsPredictor,
                                                      model_config_from_yaml)
        from adaptigraph_torch.dynamics.train import (make_optimizer,
                                                      make_train_chunk)

        sizes = sizes or {}
        t0 = time.perf_counter()
        self.seed, self.dev, self.spans = seed, device, spans
        dyn = cfg["published"]["dynamics"]
        self.dyn = dyn
        dc = dyn["dataset_config"]
        d0 = dict(dc["datasets"][0], **sizes.get("dataset", {}))
        rnd = dc["randomness"]
        self.b = int(sizes.get("batch_size",
                               dyn["train_config"]["batch_size"]))
        self.k = int(sizes.get("steps_per_chunk", traffic["steps_per_chunk"]))
        self.lr = float(dyn["train_config"].get("lr", traffic["lr"]))
        n_eef = int(dc["eef"]["max_neef"])
        self.ds = SimpleNamespace(
            n_his=int(dc["n_his"]), n_future=int(dc["n_future"]),
            max_nobj=int(d0["max_nobj"]), max_nR=int(d0["max_nR"]),
            topk=int(d0["topk"]),
            connect_tool_all=bool(d0["connect_tool_all"]),
            fps_radius_range=tuple(d0["fps_radius_range"]),
            adj_radius_range=tuple(d0["adj_radius_range"]),
            augment=bool(rnd["use"]),
            state_noise=float(rnd["state_noise"]["train"]),
            phys_noise=float(rnd["phys_noise"]["train"]))
        if self.ds.phys_noise > 0:
            raise ValueError("physics noise is not drawn by this driver")
        phys_dim = 1
        self.widths = ref_model.widths(dyn["model_config"], self.ds.n_his,
                                       phys_dim)
        self.weights = inputs.weights(ref_model.layer_shapes(*self.widths),
                                      cfg["assumed"]["weights"], seed, device)

        self.marks = {"weights": time.perf_counter() - t0}
        ep = dict(cfg["assumed"]["episodes"], **sizes.get("episodes", {}))
        obj, eef = inputs.episodes(seed, ep, n_eef, device)
        self.marks["episodes"] = time.perf_counter() - t0
        e, t, n_raw = obj.shape[:3]
        span = (self.ds.n_his + self.ds.n_future - 1) * int(ep["pair_stride"])
        starts = torch.arange(t - span, device=device)
        frames = starts[:, None] + torch.arange(
            0, span + 1, int(ep["pair_stride"]), device=device)
        pairs = torch.cat([torch.arange(e, device=device).repeat_interleave(
            starts.numel())[:, None], frames.repeat(e, 1)], 1).to(torch.int32)
        self.common = {"obj": obj, "eef": eef,
                       "nobj": torch.full((e,), n_raw, dtype=torch.int32,
                                          device=device),
                       "phys": torch.full((e, phys_dim),
                                          float(cfg["physics_param"]),
                                          device=device)}
        self.pairs = pairs

        mc = model_config_from_yaml(dyn["model_config"], dc, phys_dim)
        self.mode = (mc.aggregation,
                     str(mc.compute_dtype).replace("torch.", ""))
        model = DynamicsPredictor(mc, device=device)
        model.load_state_dict(self.weights, strict=True)
        self.model = model
        self.marks["model"] = time.perf_counter() - t0
        self.opt, _ = make_optimizer(model.parameters(), self.lr)
        self.marks["optimizer"] = time.perf_counter() - t0
        self.graph_seed = inputs.seed_for(seed, "graphs")
        gen = torch.Generator(device=device).manual_seed(self.graph_seed)
        self.train_chunk, _ = make_train_chunk(
            model, self.ds.n_future, self.opt, self.ds, self.common, pairs,
            gen)
        self.marks["chunk"] = time.perf_counter() - t0
        self.batch_gen = inputs.generator(seed, "batches", device)
        n_pairs = pairs.shape[0]
        if n_pairs < self.k * self.b:
            raise ValueError(f"{n_pairs} frame windows cannot give {self.k} "
                             f"steps of {self.b} distinct rows")
        self.first = torch.randperm(n_pairs, generator=self.batch_gen,
                                    device=device)[:self.k * self.b].view(
                                        self.k, self.b)

    def warm_up(self):
        """The first chunk, with its steps 1 and 3 copied aside."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        seen = {"step": 0}

        def after(opt, args, kwargs):
            seen["step"] += 1
            if seen["step"] == 1:
                self.grad1 = {names[id(p)]: opt.state[p]["exp_avg"] / 0.1
                              for g in opt.param_groups for p in g["params"]}
            if seen["step"] == FOLLOWED:
                self.params3 = {n: p.detach().clone()
                                for n, p in self.model.named_parameters()}
        hook = self.opt.register_step_post_hook(after)
        self.losses = self.train_chunk(self.first.cpu().numpy())
        hook.remove()
        self.losses = self.losses.clone()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _hooks(self):
        """Spans: the graph preparation, forward and backward (from the
        preparation's end to Adam's start), Adam."""
        import adaptigraph_torch.dynamics.dataset as dsm
        spans = self.spans
        prep = dsm.prepare_graph_batch

        def prepare(*a, **k):
            with host_span("prepare"), spans.span("prepare"):
                out = prep(*a, **k)
            spans.start("fwd_bwd")
            return out
        dsm.prepare_graph_batch = prepare

        def before(opt, args, kwargs):
            spans.stop("fwd_bwd")
            spans.start("adam")

        def after(opt, args, kwargs):
            spans.stop("adam")
            spans.count("steps")
        h1 = self.opt.register_step_pre_hook(before)
        h2 = self.opt.register_step_post_hook(after)

        def undo():
            dsm.prepare_graph_batch = prep
            h1.remove()
            h2.remove()
        return undo

    def window(self, seconds: float, profiled=None) -> dict:
        """Chunks back to back, each on a (K, B) table drawn on the host
        as train() draws it and handed to the chunk as train() hands it."""
        undo = self._hooks() if self.spans.enabled else None
        rng = np.random.default_rng(self.seed)
        n = self.pairs.shape[0]
        chunks = 0
        t0 = time.perf_counter()
        while True:
            idx = rng.integers(0, n, size=(self.k, self.b)).astype(np.int32)
            if profiled is not None and chunks == 2:
                with profiled, host_span("train.chunk"):
                    steps0 = self.spans.counters["steps"]
                    self.train_chunk(idx)
                self.steps_profiled = self.spans.counters["steps"] - steps0
            else:
                self.train_chunk(idx)
            chunks += 1
            if time.perf_counter() - t0 >= seconds and (
                    profiled is None or chunks > 2):
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if undo is not None:
            undo()
        self.steps = chunks * self.k
        return {"wall_s": wall, "attempted": self.steps * self.b,
                "steps": self.steps}

    def end_to_end(self, w: dict) -> dict:
        return {"train_samples_per_s": (w["attempted"] / w["wall_s"], UNIT)}

    def free(self):
        self.train_chunk = None
        self.opt = None
        self.model = None

    def _reference(self, precision: str, half: bool = False):
        """The reference's first three steps: (losses, first gradient,
        parameters after three, the graphs' valid counts). half=True is a
        fault: each loss the mean over the batch's first half alone."""
        ds, dev = self.ds, self.dev
        gen = torch.Generator(device=dev).manual_seed(self.graph_seed)
        params = {k: v.clone() for k, v in self.weights.items()}
        adam = ref_train.Adam(params, self.lr)
        losses, grad1, counts = [], None, []
        pstep = int(self.dyn["model_config"]["pstep"])
        n_nodes = ds.max_nobj + self.common["eef"].shape[2]
        for step in range(FOLLOWED):
            rows = self.pairs[self.first[step].long()].long()
            epi, frames = rows[:, 0], rows[:, 1:]
            obj = self.common["obj"][epi[:, None], frames]
            eef = self.common["eef"][epi[:, None], frames]
            d = ref_train.draws(gen, self.b, self.common["nobj"][epi].long(),
                                ds.max_nobj, ds.fps_radius_range,
                                ds.adj_radius_range, ds.augment, ds.n_his,
                                n_nodes, ds.state_noise)
            g = ref_train.graphs(obj, eef, self.common["phys"][epi], d,
                                 n_his=ds.n_his, n_future=ds.n_future,
                                 max_nobj=ds.max_nobj, max_nR=ds.max_nR,
                                 topk=ds.topk, augment=ds.augment)
            counts.append((g["nodes"], g["nodes"] - self.b *
                           self.common["eef"].shape[2], g["n_edges"]))
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            with matmul_precision(precision):
                loss = ref_train.unrolled_loss(
                    leaves, g, ds.n_future, pstep, precision,
                    rows=self.b // 2 if half else None)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            grads = dict(zip(leaves, grads))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = grads
            params = adam.step(params, grads)
        return losses, grad1, params, counts

    def check(self, stand_in=None) -> dict:
        """The compared numbers; `stand_in` (the control) replaces the
        program's readings by a (losses, first gradient, parameters after
        three) of its own."""
        losses, grad1, params3, counts = self._reference("f32")
        self.counts = counts
        got = stand_in or ([float(x) for x in self.losses[:FOLLOWED]],
                           self.grad1, self.params3)
        step_gaps = [abs(a - b) / abs(b) for a, b in zip(got[0], losses)]
        gnorm = {k: float(v.norm()) for k, v in grad1.items()}
        med = float(torch.tensor(list(gnorm.values())).median())
        moved = [k for k in gnorm if gnorm[k] >= 1e-3 * med]
        self.left_out = sorted(set(gnorm) - set(moved))

        def gaps(ref, prog):
            """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), median)}"""
            norms = {k: float(ref[k].norm()) for k in moved}
            m = float(torch.tensor(list(norms.values())).median())
            return {k: abs(float(prog[k].norm()) - norms[k]) / max(norms[k], m)
                    for k in moved}

        grad = gaps(grad1, got[1])
        change = gaps({k: params3[k] - self.weights[k] for k in moved},
                      {k: got[2][k] - self.weights[k] for k in moved})
        out = {"loss_gap": max(step_gaps), "grad_gap": max(grad.values()),
               "update_gap": max(change.values())}
        out.update({f"loss_gap_step{i + 1}": g
                    for i, g in enumerate(step_gaps)})
        out["grad_gap_worst_leaf"] = max(grad, key=grad.get)
        out["update_gap_worst_leaf"] = max(change, key=change.get)
        out["grad_gap_median_leaf"] = float(torch.tensor(list(grad.values()))
                                            .median())
        out["update_gap_median_leaf"] = float(torch.tensor(
            list(change.values())).median())
        return out

    def control(self, precision: str, half: bool = False):
        """The reference in the program's place: its readings at
        `precision`, or with half of each batch left out."""
        losses, grad1, params3, _ = self._reference(precision, half)
        return losses, grad1, params3

    def flops(self) -> float:
        """The unrolled forward and backward (three forwards' worth) of
        every step in the window, at the followed steps' mean of valid
        nodes, objects and edges a step."""
        nf, p_in, r_in = self.widths
        pstep = int(self.dyn["model_config"]["pstep"])
        per = sum(forward_flops(n, o, e, nf, p_in, r_in, pstep)
                  for n, o, e in self.counts) / len(self.counts)
        return 3.0 * self.ds.n_future * per * self.steps

    def mfu(self, wall_s: float) -> float:
        return share_of_peak(self.flops(), wall_s, "float32")
