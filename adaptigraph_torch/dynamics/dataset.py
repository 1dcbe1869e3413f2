"""The dynamics dataset's host side: the port of episode_names, load_pairs,
normalize_physics, load_dataset, load_positions and DynDataset (with
raw_batch) of adaptigraph_tpu/dynamics/dataset.py, and its training
half: the graph assembly of `_prepare_one` / `make_prepare_fn` as one
batched function on the tensors' device.

Loaders of src/dynamics/dataset/load.py:6-83 in the reference: the
train/valid episode-ratio splits and min-max physics-param normalization
from material_config. Files are read with pickle and numpy only.

Graph assembly (the reference's dataset.py:73-252: FPS subsampling,
padding, masks, noise and rotation augmentation, radius-graph edges) runs
on the raw windows' device for the whole batch at once:
`prepare_graph_batch(raw, draws)`. Its randomness comes in as `draws`
(`draw_prepare`), which replace JAX's six per-sample keys; only what is
used is drawn (augment off: no state noise, no rotation; phys_noise 0: no
physics noise). The rotation is written out element by element and its
cos and sin taken in float64, so that the card and the CPU round it alike.
Its spans (utils/profiling): `prepare.fps` (both FPS stages) and
`prepare.edges` (the radius graph).
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
import torch

from adaptigraph_torch.ops.edges import (build_edges_batch,
                                         build_edges_slotted_batch)
from adaptigraph_torch.ops.fps import fps_subsample_batch, start_ranks
from adaptigraph_torch.sim.episode_io import load_property_params
from adaptigraph_torch.utils import profiling
from adaptigraph_torch.utils.geometry import rotation_2d_z


def episode_names(data_dir: str, pairs_dir: str):
    """Episode dir names in preprocess order, filtered to those with
    emitted frame pairs: the canonical ordinal <-> name mapping (dir names
    need not be contiguous)."""
    return sorted(f for f in os.listdir(data_dir)
                  if os.path.isdir(os.path.join(data_dir, f)) and f.isdigit()
                  and glob.glob(os.path.join(pairs_dir, f"{f}_*.txt")))


def load_pairs(pairs_path: str, names, ordinals) -> np.ndarray:
    """Frame-pair rows for the given episode dir names; the first column is
    the episode ORDINAL (index into the preprocess positions lists)."""
    rows = []
    for nm, ordinal in zip(names, ordinals):
        n_pushes = len(glob.glob(os.path.join(pairs_path, f"{nm}_*.txt")))
        for push in range(1, n_pushes + 1):
            fp = np.loadtxt(os.path.join(pairs_path, f"{nm}_{push:02}.txt"))
            if fp.ndim == 1:
                continue
            rows.append(np.concatenate(
                [np.full((fp.shape[0], 1), ordinal), fp], axis=1))
    return (np.concatenate(rows, axis=0).astype(int) if rows
            else np.zeros((0, 8), int))


def normalize_physics(props: dict, material_params) -> np.ndarray:
    used = []
    for item in material_params:
        if item["name"] in props and item["use"]:
            lo, hi = float(item["min"]), float(item["max"])
            used.append((float(props[item["name"]]) - lo) / (hi - lo + 1e-6))
    return np.array(used, dtype=np.float32)


def load_dataset(dataset_config, material_config, phase="train"):
    data_name = dataset_config["data_name"]
    data_dir = os.path.join(dataset_config["data_dir"], data_name)
    prep_dir = os.path.join(dataset_config["prep_data_dir"], data_name)
    ratio = dataset_config["ratio"][phase]
    pairs_dir = os.path.join(prep_dir, "frame_pairs")
    names = episode_names(data_dir, pairs_dir)
    num_epis = len(names)
    lo, hi = int(num_epis * ratio[0]), int(num_epis * ratio[1])
    pair_lists = load_pairs(pairs_dir, names[lo:hi], range(lo, hi))

    physics_params = []
    for nm in names:
        props = load_property_params(os.path.join(data_dir, nm))
        per_mat = {}
        for mat in dataset_config["materials"]:
            per_mat[mat] = normalize_physics(
                props, material_config[mat]["physics_params"])
        physics_params.append(per_mat)
    return pair_lists, physics_params


def load_positions(dataset_config):
    """(eef_pos, obj_pos) lists of the preprocessed positions.pkl (a pickle
    the preprocessing step wrote)."""
    prep_dir = os.path.join(dataset_config["prep_data_dir"],
                            dataset_config["data_name"])
    with open(os.path.join(prep_dir, "positions.pkl"), "rb") as f:
        positions = pickle.load(f)
    return positions["eef_pos"], positions["obj_pos"]


class DynDataset:
    """Host-side index and raw gather of frame windows."""

    def __init__(self, dataset_config, material_config, phase="train"):
        if phase not in ("train", "valid"):
            raise ValueError(f"phase {phase!r} is not 'train' or 'valid'")
        self.phase = phase
        self.cfg = dataset_config
        self.n_his = int(dataset_config["n_his"])
        self.n_future = int(dataset_config["n_future"])
        rnd = dataset_config["randomness"]
        self.augment = bool(rnd["use"]) and phase == "train"
        self.state_noise = float(rnd["state_noise"][phase])
        self.phys_noise = float(rnd["phys_noise"][phase])
        ds = dataset_config["datasets"][0]
        self.max_nobj = int(ds["max_nobj"])
        self.max_nR = int(ds["max_nR"])
        self.fps_radius_range = tuple(ds["fps_radius_range"])
        self.adj_radius_range = tuple(ds["adj_radius_range"])
        self.topk = int(ds["topk"])
        self.connect_tool_all = bool(ds["connect_tool_all"])
        self.material = dataset_config["materials"][0]

        self.pair_lists, self.physics_params = load_dataset(
            dataset_config, material_config, phase)
        self.eef_pos, self.obj_pos = load_positions(dataset_config)
        self.n_eef = self.eef_pos[0].shape[1]
        self.n_raw = max(o.shape[1] for o in self.obj_pos)
        self.phys_dim = self.physics_params[0][self.material].shape[0]

    def __len__(self):
        return len(self.pair_lists)

    def raw_batch(self, idxs: np.ndarray) -> dict:
        """Gather raw windows: obj (B, T_w, N_raw, 3), eef (B, T_w, N_eef,
        3), valid-count + physics. T_w = n_his + n_future."""
        b = len(idxs)
        t_w = self.n_his + self.n_future
        obj = np.zeros((b, t_w, self.n_raw, 3), np.float32)
        nobj_raw = np.zeros((b,), np.int32)
        eef = np.zeros((b, t_w, self.n_eef, 3), np.float32)
        phys = np.zeros((b, self.phys_dim), np.float32)
        for i, idx in enumerate(idxs):
            row = self.pair_lists[idx]
            epi, pair = int(row[0]), row[1:]
            o = self.obj_pos[epi]
            e = self.eef_pos[epi]
            n = o.shape[1]
            for t in range(t_w):
                obj[i, t, :n] = o[pair[t]]
                eef[i, t] = e[pair[t]]
            nobj_raw[i] = n
            phys[i] = self.physics_params[epi][self.material]
        return {"obj": obj, "eef": eef, "nobj_raw": nobj_raw, "physics": phys}


def draw_prepare(generator, raw, dataset):
    """The random draws of one batch's graph assembly, from `generator` (a
    torch.Generator; the draws are made on its device and returned on the
    raw windows'): the two FPS start ranks, the FPS and adjacency radii,
    and where used the state noise and rotation angle (augment) and the
    physics noise (phys_noise > 0). All uniform, over the ranges JAX draws
    from at dynamics/dataset.py:158-206."""
    obj = raw["obj"]
    dev = torch.as_tensor(obj).device
    b = obj.shape[0]
    gdev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=gdev)
        return (lo + (hi - lo) * u).to(dev)

    nobj = torch.as_tensor(raw["nobj_raw"]).to(gdev)
    u = torch.rand((b, 2), generator=generator, device=gdev)
    draws = {"fps_ranks": start_ranks(u, nobj, dataset.max_nobj).to(dev),
             "fps_r": uniform((b,), *dataset.fps_radius_range),
             "adj_r": uniform((b,), *dataset.adj_radius_range)}
    if dataset.augment:
        n = dataset.max_nobj + raw["eef"].shape[2]
        sn = dataset.state_noise
        draws["state_noise"] = uniform((b, dataset.n_his, n, 3), -sn, sn)
        draws["theta"] = uniform((b,), -np.pi, np.pi)
    if dataset.phys_noise > 0:
        pn = dataset.phys_noise
        draws["phys_noise"] = uniform(tuple(raw["physics"].shape), -pn, pn)
    return draws


def _rotate(x, rot):
    """x (B, ..., 3) @ rot (B, 3, 3), each output the float32 sum
    x0 r0j + x1 r1j + x2 r2j in that order, one operation at a time."""
    r = rot.reshape((rot.shape[0],) + (1,) * (x.dim() - 2) + (3, 3))
    return (x[..., 0:1] * r[..., 0, :] + x[..., 1:2] * r[..., 1, :]
            + x[..., 2:3] * r[..., 2, :])


def prepare_graph_batch(raw, draws, *, n_his, n_future, max_nobj, max_nR,
                        topk, connect_tool_all, augment, slotted=False):
    """B training graphs from raw windows (`DynDataset.raw_batch` or the
    device gather, as tensors: obj (B, T_w, N_raw, 3), eef (B, T_w, N_eef,
    3), nobj_raw (B,), physics (B, P)) and their `draws`, on the windows'
    device. The batched `_prepare_one` of JAX (dataset.py:151-236): the
    same keys, shapes and values. slotted=True emits slot-layout edges
    (build_edges_slotted) for the slotted aggregation modes."""
    obj = torch.as_tensor(raw["obj"])
    dev = obj.device
    eef = torch.as_tensor(raw["eef"]).to(dev)
    nobj_raw = torch.as_tensor(raw["nobj_raw"]).to(dev)
    physics = torch.as_tensor(raw["physics"]).to(dev)
    b, t_w, n_raw, _ = obj.shape
    n_eef = eef.shape[2]

    raw_valid = torch.arange(n_raw, device=dev)[None, :] < nobj_raw[:, None]
    with profiling.span("prepare.fps"):
        fps_idx, keep = fps_subsample_batch(obj[:, n_his - 1], max_nobj,
                                            draws["fps_r"],
                                            draws["fps_ranks"], raw_valid)
    gather = fps_idx.long()[:, None, :, None].expand(b, t_w, max_nobj, 3)
    keep_f = keep.to(torch.float32)
    obj_kp = torch.gather(obj, 2, gather) * keep_f[:, None, :, None]

    def tools(rows):  # (B, T, N_eef, 3) tool rows under zero object rows
        z = rows.new_zeros(rows.shape[:2] + (max_nobj, 3))
        return torch.cat([z, rows], dim=2)

    # action = eef delta at the current step (the reference's
    # dataset.py:105-110)
    states_delta = tools((eef[:, n_his] - eef[:, n_his - 1])[:, None])[:, 0]
    state_history = torch.cat([obj_kp[:, :n_his], eef[:, :n_his]], dim=2)
    obj_future = obj_kp[:, n_his:]
    eef_future = tools(eef[:, n_his:n_his + n_future - 1])
    delta_future = tools(eef[:, n_his + 1:n_his + n_future]
                         - eef[:, n_his:n_his + n_future - 1])

    ones = torch.ones((b, n_eef), dtype=torch.bool, device=dev)
    state_mask = torch.cat([keep, ones], dim=1)
    eef_mask = torch.cat([torch.zeros_like(keep), ones], dim=1)
    attrs = torch.cat([
        torch.stack([keep_f, torch.zeros_like(keep_f)], dim=-1),
        torch.tensor([0.0, 1.0], device=dev).expand(b, n_eef, 2)], dim=1)
    p_instance = keep_f[:, :, None]

    if "phys_noise" in draws:
        physics = physics + draws["phys_noise"]
    if augment:
        state_history = state_history + draws["state_noise"]
        # the reference's xy-plane rotation (dataset.py:187-190)
        rot = rotation_2d_z(draws["theta"].double()).float()
        state_history = _rotate(state_history, rot)
        states_delta = _rotate(states_delta, rot)
        eef_future = _rotate(eef_future, rot)
        delta_future = _rotate(delta_future, rot)
        obj_future = _rotate(obj_future, rot)

    with profiling.span("prepare.edges"):
        if slotted:
            edges = build_edges_slotted_batch(
                state_history[:, -1], draws["adj_r"], state_mask, eef_mask,
                topk=topk, connect_tools_all=connect_tool_all,
                tools_only_when_near=False, tool_slots=n_eef)
        else:
            edges = build_edges_batch(
                state_history[:, -1], draws["adj_r"], state_mask, eef_mask,
                topk=topk, connect_tools_all=connect_tool_all,
                tools_only_when_near=False, max_edges=max_nR)
    return {
        "state": state_history,
        "action": states_delta,
        "eef_future": eef_future,
        "action_future": delta_future,
        "state_future": obj_future,
        "attrs": attrs,
        "p_instance": p_instance,
        "obj_mask": keep,
        "state_mask": state_mask,
        "eef_mask": eef_mask,
        "recv": edges.receivers,
        "send": edges.senders,
        "edge_valid": edges.valid,
        "physics_param": physics,
    }


def make_prepare_fn(dataset: DynDataset, slotted: bool = False):
    """(raw, draws) -> graph batch with `dataset`'s settings
    (`prepare_graph_batch`); slotted=True emits slot-layout edges for
    models in a slotted aggregation mode."""
    kwargs = dict(
        n_his=dataset.n_his, n_future=dataset.n_future,
        max_nobj=dataset.max_nobj, max_nR=dataset.max_nR, topk=dataset.topk,
        connect_tool_all=dataset.connect_tool_all, augment=dataset.augment,
        slotted=slotted)

    def prepare(raw, draws):
        return prepare_graph_batch(raw, draws, **kwargs)

    return prepare
