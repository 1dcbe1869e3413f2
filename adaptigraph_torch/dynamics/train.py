"""GNN dynamics training: the port of adaptigraph_tpu/dynamics/train.py.

Mirrors the reference trainer (src/dynamics/train/train.py:19-148): Adam
lr 1e-3, batch 128, multi-step supervision: unroll n_future=3
predictions, feeding each prediction back into the history window with
the recorded future eef rows (train.py:90-108), sum the per-step MSE, one
update. Checkpoints every 10th epoch (<100) / 100th epoch, and `latest`
with the optimizer state (train.py:127-130).

Structure on the device:
  * graph assembly runs on the device (dataset.prepare_graph_batch), for
    the whole batch at once, its randomness drawn there from one
    torch.Generator (dataset.draw_prepare);
  * when the padded episode frames fit (`device_dataset`), they stay
    resident on the device and a K-step chunk (`make_train_chunk`) takes
    K (gather -> prepare -> forward and backward -> Adam) steps from one
    (K, B) index table the host ships, reading the K losses back once;
    otherwise `train` runs the per-step host loop over
    DynDataset.raw_batch.

Spans (utils/profiling), no counters, so that a traced step launches what
an untraced one does: `train.chunk` around a chunk, `train.step` around
each of its steps, `train.batch` (the gather and the graph draws),
`train.prepare` (the graph assembly, its children `prepare.fps` and
`prepare.edges`), `train.forward` (the unrolled loss), `train.backward`
and `train.adam` (Adam's step and the scheduler's).

On a mesh (parallel/mesh.py's 1-D data mesh or 2-D data x model mesh,
one process a device) each rank draws the whole batch's indices and
graph draws, keeps its data row's rows (shard_batch's rule: a batch the
whole mesh does not divide stays whole on every rank) and averages the
gradient and the loss over the data ranks, summed in rank order, before
Adam, which then steps alike on every rank of a model column. Rank 0
alone writes the checkpoints and the loss files, and prints. train()
replicates the params over the mesh, as JAX's does; the column-parallel
layout is make_train_step on a model that parallel.shard_params_model
has laid out.

Batch indices come from np.random.RandomState(random_seed) in the JAX
package's order, so both packages train on the same pairs; the graph
draws cannot replay JAX's threefry stream. Adam is torch.optim.Adam with
optax's defaults (b1 0.9, b2 0.999, eps 1e-8), float32 products in full
precision (TF32 off). Checkpoints are torch.save files: `NAME.pt` the
model's state_dict (what the rollout and planning CLIs take as
--params) and, for `latest`, `NAME_optim.pt` the optimizer's state.

Usage: python -m adaptigraph_torch.dynamics.train --config dynamics/rope
       [--epochs N] [--iters N] [--batch N] [--resume] [--device cpu]
On several devices: torchrun --nproc-per-node N -m
adaptigraph_torch.dynamics.train ... (parallel.mesh.init_from_env starts
the process group from torchrun's environment).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from functools import partial

import numpy as np
import torch
from torch.func import functional_call

from adaptigraph_torch.dynamics.dataset import (DynDataset, draw_prepare,
                                                make_prepare_fn)
from adaptigraph_torch.dynamics.model import (DynamicsPredictor,
                                              model_config_from_yaml)
from adaptigraph_torch.parallel.mesh import (barrier, check_data_mesh,
                                             init_from_env, local_rows,
                                             make_mesh, mean_over, replicate,
                                             shard_batch, world_size)
from adaptigraph_torch.utils import load_config, profiling
from adaptigraph_torch.utils.device import full_f32_matmul, resolve_device
from adaptigraph_torch.utils.profiling import plot_loss_curves

_SLOTTED = ("slotted", "slotmm")


def make_apply(model):
    """Single-graph apply with the reference graph-dict keys: apply(params,
    g) runs `model` with `params` (a state_dict) on one graph (no batch
    dimension) and returns (pred_pos (N_obj, 3), pred_motion (N_obj, 3))."""

    def apply(params, g):
        one = {k: g[k][None] for k in (
            "state", "attrs", "recv", "send", "edge_valid", "p_instance",
            "physics_param", "action", "obj_mask")}
        pred, motion = functional_call(model, params, args=(
            one["state"], one["attrs"], one["recv"], one["send"],
            one["edge_valid"], one["p_instance"], one["physics_param"]),
            kwargs={"action": one["action"], "obj_mask": one["obj_mask"]})
        return pred[0], motion[0]

    return apply


def make_unrolled_loss(model, n_future: int):
    """unrolled_loss(params, batch): the multi-step supervision
    (train.py:90-108) over a graph batch. Each prediction is fed back into
    the history window through the recorded eef rows, not detached, so
    the gradient flows through the unroll; edges stay fixed. Each step's
    loss is the mean squared error over every object slot, padded slots
    included, as in JAX."""

    def unrolled_loss(params, batch):
        state = batch["state"]
        action = batch["action"]
        loss = 0.0
        for fi in range(n_future):
            pred, _ = functional_call(model, params, args=(
                state, batch["attrs"], batch["recv"], batch["send"],
                batch["edge_valid"], batch["p_instance"],
                batch["physics_param"]),
                kwargs={"action": action, "obj_mask": batch["obj_mask"]})
            gt = batch["state_future"][:, fi]
            loss = loss + torch.mean((pred - gt) ** 2)
            if fi < n_future - 1:
                eef_rows = batch["eef_future"][:, fi, pred.shape[1]:]
                nxt = torch.cat([pred, eef_rows], dim=1)
                state = torch.cat([state[:, 1:], nxt[:, None]], dim=1)
                action = batch["action_future"][:, fi]
        return loss

    return unrolled_loss


def loss_and_grads(loss_fn, params, batch):
    """(loss, grads): jax.value_and_grad of loss_fn at `params` (a dict of
    tensors, left untouched), grads a dict with params' keys."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def cosine_decay(count, decay_steps: int, alpha: float = 0.05):
    """optax.cosine_decay_schedule's factor on the peak lr after `count`
    updates: cosine from 1 to alpha over decay_steps, alpha after."""
    count = min(count, decay_steps)
    return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * count
                                             / decay_steps)) + alpha


def make_optimizer(params, lr: float, lr_schedule=None, decay_steps: int = 1):
    """(Adam, scheduler or None): optax.adam(lr)'s defaults; with
    lr_schedule 'cosine' a LambdaLR giving
    optax.cosine_decay_schedule(lr, decay_steps, alpha=0.05) at the count
    of updates taken, to be stepped after each update."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if lr_schedule != "cosine":
        return opt, None
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, partial(cosine_decay, decay_steps=max(1, decay_steps)))
    return opt, sched


def mean_grads_and_loss(params, loss, mesh):
    """Average the gradients of `params` (a dict of tensors after
    backward) and `loss` over the mesh's data ranks in one gather: each
    rank's gradients flattened into one vector with its loss, summed in
    rank order. On a 2-D mesh a column-parallel weight's rows differ by
    model rank and are not mixed across it. Writes the means into the
    .grad tensors; returns the mean loss."""
    grads = [p.grad for p in params.values() if p.grad is not None]
    flat = mean_over(torch.cat([g.reshape(-1) for g in grads]
                               + [loss.detach().reshape(1)]), mesh)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return flat[-1]


def make_train_step(model, n_future: int, optimizer, scheduler=None,
                    mesh=None):
    """(train_step, eval_step) on `model`'s own parameters:
    train_step(batch) takes one Adam update (and a scheduler step) and
    returns the loss before it; eval_step(batch) the loss, no gradient.
    Both return a 0-dim tensor on the device (no host sync). With a
    `mesh`, the batch is this rank's rows of the global batch: the
    gradients and the loss are averaged over the data ranks
    (mean_grads_and_loss) before Adam, and both steps return the global
    loss. The parameters are read from `model` when this is called: on a
    2-D mesh, lay the model out (parallel.shard_params_model) and build
    the optimizer first."""
    unrolled_loss = make_unrolled_loss(model, n_future)
    params = dict(model.named_parameters())

    def train_step(batch):
        optimizer.zero_grad(set_to_none=True)
        with profiling.span("train.forward"):
            loss = unrolled_loss(params, batch)
        with profiling.span("train.backward"):
            loss.backward()
        loss = loss.detach()
        if mesh is not None:
            loss = mean_grads_and_loss(params, loss, mesh)
        with profiling.span("train.adam"):
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
        return loss

    def eval_step(batch):
        with torch.no_grad():
            loss = unrolled_loss(params, batch)
            return loss if mesh is None else mean_over(loss, mesh)

    return train_step, eval_step


def split_batch(raw, draws, mesh):
    """This rank's rows of a whole batch's raw windows and graph draws
    (both as drawn on every rank); both whole without a mesh."""
    if mesh is None:
        return raw, draws
    return shard_batch(raw, mesh), shard_batch(draws, mesh)


def device_dataset(datasets: dict, max_bytes: float = 6e9, device=None):
    """The whole dataset on the device (CUDA unless given), for gathering
    batches there: (common, pairs_by_phase). common holds the padded
    frames `obj` (E, T_max, N_raw, 3) and `eef` (E, T_max, N_eef, 3), the
    raw particle counts `nobj` (E,) and physics params `phys` (E, P),
    shared by the phases; pairs_by_phase maps each phase to its
    (P, 1 + T_w) int32 pair table. (None, None) if the padded frames would
    exceed `max_bytes` (the caller falls back to the host loop)."""
    device = resolve_device(device)
    d0 = next(iter(datasets.values()))
    t_max = max(o.shape[0] for o in d0.obj_pos)
    e = len(d0.obj_pos)
    n_raw, n_eef = d0.n_raw, d0.n_eef
    if e * t_max * (n_raw + n_eef) * 3 * 4 > max_bytes:
        return None, None
    obj = np.zeros((e, t_max, n_raw, 3), np.float32)
    eef = np.zeros((e, t_max, n_eef, 3), np.float32)
    nobj = np.zeros((e,), np.int32)
    phys = np.zeros((e, d0.phys_dim), np.float32)
    for i, (o, ee) in enumerate(zip(d0.obj_pos, d0.eef_pos)):
        obj[i, : o.shape[0], : o.shape[1]] = o
        eef[i, : ee.shape[0]] = ee
        nobj[i] = o.shape[1]
        phys[i] = d0.physics_params[i][d0.material]
    common = {k: torch.from_numpy(v).to(device) for k, v in (
        ("obj", obj), ("eef", eef), ("nobj", nobj), ("phys", phys))}
    pairs = {p: torch.from_numpy(d.pair_lists.astype(np.int32)).to(device)
             for p, d in datasets.items()}
    return common, pairs


def _gather_raw(common, pairs, idx_row):
    """DynDataset.raw_batch on the device: (B,) pair indices -> the raw
    window dict (the same keys, shapes, dtypes and zero padding)."""
    rows = pairs[idx_row.long()]  # (B, 1+T_w)
    epi = rows[:, 0].long()
    frames = rows[:, 1:].long()  # (B, T_w)
    obj = common["obj"][epi[:, None], frames]  # (B, T_w, n_raw, 3)
    # zero rows beyond each episode's raw particle count (raw_batch pads
    # the same way; episodes share the padded n_raw axis here)
    nobj_raw = common["nobj"][epi]
    keep = (torch.arange(obj.shape[2], device=obj.device)[None, None, :, None]
            < nobj_raw[:, None, None, None])
    obj = torch.where(keep, obj, torch.zeros_like(obj))
    eef = common["eef"][epi[:, None], frames]
    return {"obj": obj, "eef": eef, "nobj_raw": nobj_raw,
            "physics": common["phys"][epi]}


def make_train_chunk(model, n_future: int, optimizer, dataset: DynDataset,
                     common, pairs, generator, scheduler=None, mesh=None):
    """(train_chunk, eval_chunk) over the device-resident data:
    train_chunk(idxs) takes K (gather -> graph prep -> forward and
    backward -> Adam) steps for the (K, B) index table `idxs`, its graph
    draws from `generator`, and returns the K losses as a (K,) tensor on
    the device; eval_chunk(idxs) the K losses with no update. Nothing in
    a chunk waits on the host. With a `mesh`, every rank draws the whole
    batch's graph draws and prepares its own rows (split_batch); the
    steps average over the ranks (make_train_step)."""
    train_step, eval_step = make_train_step(model, n_future, optimizer,
                                            scheduler, mesh)
    prepare = make_prepare_fn(dataset,
                              slotted=model.cfg.aggregation in _SLOTTED)
    dev = common["obj"].device

    def batch_graphs(idx_row):
        with profiling.span("train.batch"):
            raw = _gather_raw(common, pairs, idx_row)
            draws = draw_prepare(generator, raw, dataset)
        with profiling.span("train.prepare"):
            return prepare(*split_batch(raw, draws, mesh))

    def one_step(step, row):
        with profiling.span("train.step"):
            return step(batch_graphs(row))

    def run(step, idxs):
        with profiling.span("train.chunk"):
            idxs = torch.as_tensor(idxs).to(dev)
            return torch.stack([one_step(step, row) for row in idxs])

    return partial(run, train_step), partial(run, eval_step)


def init_model(config, dataset, *, generator=None, device=None):
    """(model, params) of the config's model on `device` (CUDA unless
    given): weights drawn from `generator` (a CPU torch.Generator; seeded
    with train_config.random_seed when None) as flax's default init draws
    them, `params` its state_dict. Only `dataset.phys_dim` is read: the
    input widths follow from the config."""
    device = resolve_device(device)
    mc = model_config_from_yaml(config["model_config"],
                                config["dataset_config"], dataset.phys_dim)
    if generator is None:
        generator = torch.Generator().manual_seed(
            int(config["train_config"].get("random_seed", 42)))
    model = DynamicsPredictor(mc, device=device, generator=generator)
    return model, dict(model.state_dict())


def save_checkpoint(ckpt_dir, name, params, optimizer=None, scheduler=None,
                    lr_schedule=None):
    """ckpt_dir/NAME.pt: `params` (a state_dict) on the CPU; with
    `optimizer`, NAME_optim.pt: its state, the scheduler's and the
    lr_schedule it was written under."""
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               path + ".pt")
    if optimizer is not None:
        torch.save({"optimizer": optimizer.state_dict(),
                    "scheduler": (None if scheduler is None
                                  else scheduler.state_dict()),
                    "lr_schedule": lr_schedule}, path + "_optim.pt")


def load_checkpoint(ckpt_dir, name, device=None):
    """The state_dict saved as NAME, on `device` (CUDA unless given).
    name='best' falls back to 'latest' (the best-valid checkpoint only
    exists once a validation epoch has improved; see train())."""
    device = resolve_device(device)
    path = os.path.join(os.path.abspath(ckpt_dir), name + ".pt")
    if name == "best" and not os.path.exists(path):
        path = os.path.join(os.path.abspath(ckpt_dir), "latest.pt")
    return torch.load(path, map_location=device, weights_only=True)


def _restore_optimizer(path, optimizer, scheduler, lr_schedule, device):
    """Load NAME_optim.pt into optimizer (and scheduler) when it was
    written under the same lr_schedule; else keep the fresh state, as JAX
    does where optax's state tree of plain and scheduled Adam differ."""
    saved = torch.load(path, map_location=device, weights_only=True)
    if saved["lr_schedule"] != lr_schedule:
        print(f"optimizer state written under lr_schedule "
              f"{saved['lr_schedule']!r}, not {lr_schedule!r}; keeping "
              f"fresh optimizer state", flush=True)
        return
    optimizer.load_state_dict(saved["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(saved["scheduler"])


def _quiet(*args, **kwargs):
    """print's stand-in on ranks other than 0."""


def _write_epoch(ckpt_dir, out_dir, ep, params, history, optimizer,
                 scheduler, lr_schedule, png_skipped):
    """The files of epoch `ep`: model_<ep>.pt every 10th epoch below 100
    and every 100th, `latest` with the optimizer state, `best` when the
    valid loss is the lowest yet (small datasets overfit over long
    budgets, so rollout and planning prefer it when present),
    train_state.json, the loss files and loss.png (skipped, once said,
    without matplotlib). Returns whether loss.png is skipped."""
    if (ep < 100 and ep % 10 == 0) or ep % 100 == 0:
        save_checkpoint(ckpt_dir, f"model_{ep}", params)
    save_checkpoint(ckpt_dir, "latest", params, optimizer, scheduler,
                    lr_schedule)
    if history.get("valid") and history["valid"][-1] == min(
            history["valid"]):
        save_checkpoint(ckpt_dir, "best", params)
    with open(os.path.join(out_dir, "train_state.json"), "w") as f:
        json.dump({"epoch": ep}, f)
    np.savetxt(os.path.join(out_dir, "loss_train.txt"), history["train"])
    if history.get("valid"):
        np.savetxt(os.path.join(out_dir, "loss_valid.txt"), history["valid"])
    if not png_skipped:
        try:
            plot_loss_curves(history["train"], history.get("valid"),
                             os.path.join(out_dir, "loss.png"))
        except ImportError:
            print("matplotlib is not installed: loss.png skipped",
                  flush=True)
            return True
    return png_skipped


def train(config, epochs=None, iters=None, batch_size=None, mesh=None,
          steps_per_call=8, resume=False, wall_budget_s=None, device=None):
    """Train the config's dynamics model on `device` (CUDA unless given);
    returns (params, history): the state_dict and the per-epoch mean
    losses {'train': [...], 'valid': [...]}.

    steps_per_call: K steps a device chunk over the resident dataset;
    falsy, or data beyond device_dataset's max_bytes, runs the per-step
    host loop.
    resume=True restarts from the `latest` checkpoint (+ optimizer state +
    the epoch counter in train_state.json) when present. wall_budget_s:
    stop cleanly (checkpoint and history intact) once the next epoch would
    exceed this wall-clock budget.
    mesh: a 1-D ('data',) mesh from parallel.mesh.make_mesh or a 2-D
    ('data', 'model') mesh from make_mesh_2d, the batch split over its
    data axis and the params replicated (see the module docstring); None
    takes make_mesh() when a process group of more than one process is
    initialised, as JAX's `mesh or make_mesh()` takes every device, and
    one device otherwise. Every rank calls train() alike; each returns
    the same params and history."""
    device = resolve_device(device)
    if mesh is None and world_size() > 1:
        mesh = make_mesh(device=device)
    if mesh is not None:
        check_data_mesh(mesh)
    lead = mesh is None or mesh.get_rank() == 0
    say = print if lead else _quiet
    full_f32_matmul()
    dataset_config = config["dataset_config"]
    train_config = config["train_config"]
    out_dir = os.path.join(train_config["out_dir"], dataset_config["data_name"])
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)

    datasets = {p: DynDataset(dataset_config, config["material_config"], p)
                for p in train_config.get("phases", ["train", "valid"])}

    model, _ = init_model(config, datasets["train"], device=device)
    if mesh is not None:
        model.load_state_dict(replicate(model.state_dict(), mesh))
    slotted = model.cfg.aggregation in _SLOTTED
    preps = {p: make_prepare_fn(d, slotted=slotted)
             for p, d in datasets.items()}
    # lr from config (train_config.lr, reference default 1e-3);
    # train_config.lr_schedule == 'cosine' decays it over the whole budget
    # to 5% of the peak (not in the reference, which keeps lr fixed)
    lr = float(train_config.get("lr", 1e-3))
    n_epochs = epochs if epochs is not None else int(train_config["n_epochs"])
    lr_schedule = train_config.get("lr_schedule")
    it_train = iters if iters is not None else int(
        train_config["n_iters_per_epoch"]["train"])
    optimizer, scheduler = make_optimizer(model.parameters(), lr, lr_schedule,
                                          n_epochs * it_train)
    n_future = int(dataset_config["n_future"])
    b = batch_size or int(train_config["batch_size"])
    # the batch splits over the mesh when its size divides it; otherwise
    # every rank takes the whole batch and nothing is averaged
    split = mesh if mesh is not None and local_rows(b, mesh) else None
    train_step, eval_step = make_train_step(model, n_future, optimizer,
                                            scheduler, split)

    seed = int(train_config.get("random_seed", 42))
    rng = np.random.RandomState(seed)
    generator = torch.Generator(device=device).manual_seed(seed)

    # device-resident dataset + K-step chunks when the padded frames fit;
    # the per-step host loop otherwise
    chunks = None
    if steps_per_call and steps_per_call > 1:
        common, pairs = device_dataset(datasets, device=device)
        if common is not None:
            chunks = {p: make_train_chunk(model, n_future, optimizer,
                                          datasets[p], common, pairs[p],
                                          generator, scheduler, split)
                      for p in datasets}

    history = {"train": [], "valid": []}
    epoch0 = 0
    latest = os.path.join(os.path.abspath(ckpt_dir), "latest")
    meta_p = os.path.join(out_dir, "train_state.json")
    if resume and os.path.exists(latest + ".pt") and os.path.exists(meta_p):
        model.load_state_dict(load_checkpoint(ckpt_dir, "latest", device))
        if os.path.exists(latest + "_optim.pt"):
            _restore_optimizer(latest + "_optim.pt", optimizer, scheduler,
                               lr_schedule, device)
        with open(meta_p) as f:
            epoch0 = int(json.load(f)["epoch"])
        for phase in history:
            fp = os.path.join(out_dir, f"loss_{phase}.txt")
            if os.path.exists(fp):
                history[phase] = list(np.atleast_1d(np.loadtxt(fp)))[:epoch0]
        if mesh is not None:
            model.load_state_dict(replicate(model.state_dict(), mesh))
        say(f"resumed from epoch {epoch0}", flush=True)

    log_interval = int(train_config.get("log_interval", 50))
    png_skipped = False
    t_start = time.time()
    epoch_times = []
    for epoch in range(epoch0, n_epochs):
        if wall_budget_s is not None and epoch_times:
            spent = time.time() - t_start
            stop = spent + max(epoch_times) > wall_budget_s
            if mesh is not None:  # rank 0's clock decides for every rank
                stop = replicate([stop], mesh)[0]
            if stop:
                say(f"wall budget {wall_budget_s:.0f}s: stopping before "
                    f"epoch {epoch} ({spent:.0f}s spent)", flush=True)
                break
        t0 = time.time()
        for phase in datasets:
            d = datasets[phase]
            n_iters = iters if iters is not None else int(
                train_config["n_iters_per_epoch"][phase])
            losses = []
            if chunks is not None:
                k = steps_per_call
                train_chunk, eval_chunk = chunks[phase]
                # a fixed (K, B) chunk: the epoch's budget rounds UP to a
                # whole number of chunks, announced once
                n_eff = -(-n_iters // k) * k
                if n_eff != n_iters and epoch == epoch0:
                    say(f"note: {phase} iters/epoch rounded {n_iters} -> "
                        f"{n_eff} (chunk size {k})", flush=True)
                for c0 in range(0, n_iters, k):
                    idxs = rng.randint(0, len(d), size=(k, b)).astype(np.int32)
                    run = train_chunk if phase == "train" else eval_chunk
                    losses.extend(run(idxs).tolist())
                    if phase == "train" and (c0 // k) % max(
                            1, log_interval // k) == 0:
                        say(f"epoch {epoch} iter {c0} loss {losses[-1]:.6f}",
                            flush=True)
            else:
                for it in range(n_iters):
                    idxs = rng.randint(0, len(d), size=b)
                    raw = {k_: torch.from_numpy(v).to(device)
                           for k_, v in d.raw_batch(idxs).items()}
                    draws = draw_prepare(generator, raw, d)
                    g = preps[phase](*split_batch(raw, draws, split))
                    step = train_step if phase == "train" else eval_step
                    losses.append(float(step(g)))
                    if phase == "train" and it % log_interval == 0:
                        say(f"epoch {epoch} iter {it} loss {losses[-1]:.6f}",
                            flush=True)
            history[phase].append(float(np.mean(losses)))
            say(f"epoch {epoch} {phase} loss {history[phase][-1]:.6f}",
                flush=True)

        ep = epoch + 1
        if lead:
            png_skipped = _write_epoch(
                ckpt_dir, out_dir, ep, model.state_dict(), history,
                optimizer, scheduler, lr_schedule, png_skipped)
        epoch_times.append(time.time() - t0)
        say(f"epoch {epoch} time {epoch_times[-1]:.1f}s", flush=True)
    if mesh is not None:  # no rank reads rank 0's files before they exist
        barrier(mesh)
    return model.state_dict(), history


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default="dynamics/rope")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="cpu to train on the CPU (default: CUDA)")
    args = ap.parse_args()
    init_from_env(args.device)
    train(load_config(args.config), epochs=args.epochs, iters=args.iters,
          batch_size=args.batch, resume=args.resume, device=args.device)
