"""The dynamics dataset's host side: the port of episode_names, load_pairs,
normalize_physics, load_dataset, load_positions and DynDataset (with
raw_batch) of adaptigraph_tpu/dynamics/dataset.py.

Loaders of src/dynamics/dataset/load.py:6-83 in the reference: the
train/valid episode-ratio splits and min-max physics-param normalization
from material_config. The rollout evaluator builds a DynDataset; the
training graph assembly (`_prepare_one`, `make_prepare_fn`) comes with the
training slice. Files are read with pickle and numpy only.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from adaptigraph_torch.sim.episode_io import load_property_params


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
