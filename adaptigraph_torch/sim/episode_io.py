"""Episode serialization: the port of adaptigraph_tpu/sim/episode_io.py.

The JAX package writes one h5 file a push; the port writes one
compressed numpy archive a push, `NN.npz`, keyed by the h5 dataset paths,
so that it needs no h5py (the card's machine has none):

  info/n_cams, info/timestamp, info/n_particles
  action                      (action_dim,)
  positions                   (T, N, 3) float32
  eef_states                  (T, N_eef, 14) float32
  observations/color/cam_{i}  (T, H, W, 3) uint8 RGB
  observations/depth/cam_{i}  (T, H, W) uint16 depth in mm

The dtypes are the h5 form's, and `load_data` returns the nested dict the
JAX package's load_data returns, so an episode converts to h5 key by key.
Colour channels are flipped BGR->RGB and depth scaled x1000 exactly like
the reference's process_imgs (data.py:39-52).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def process_imgs(imgs_list):
    """Two accepted frame forms:
    * (T, n_cam, H, W, 5) float RGBA+depth frames;
    * a list of T (color (n_cam, H, W, 3) uint8, depth (n_cam, H, W)
      uint16) pairs, quantised on the device by the renderer."""
    if isinstance(imgs_list, (list, tuple)) and len(imgs_list) \
            and isinstance(imgs_list[0], tuple):
        c_stack = np.stack([c for c, _ in imgs_list])  # (T, n_cam, H, W, 3)
        d_stack = np.stack([d for _, d in imgs_list])  # (T, n_cam, H, W)
        n_cam = c_stack.shape[1]
        color = {f"cam_{c}": c_stack[:, c, ..., ::-1] for c in range(n_cam)}
        depth = {f"cam_{c}": d_stack[:, c] for c in range(n_cam)}
        return color, depth
    imgs_list = np.asarray(imgs_list)
    t, n_cam = imgs_list.shape[:2]
    color, depth = {}, {}
    for c in range(n_cam):
        img = imgs_list[:, c]
        rgb = img[..., :3][..., ::-1]  # data.py:46 channel flip
        color[f"cam_{c}"] = (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)
        depth[f"cam_{c}"] = (img[..., -1] * 1000).astype(np.uint16)
    return color, depth


def store_data(filename: str, data, action: np.ndarray):
    imgs_list, particle_list, eef_list = data
    particles = np.array(particle_list)
    eefs = np.array(eef_list)
    if isinstance(imgs_list, (list, tuple)) and len(imgs_list) \
            and isinstance(imgs_list[0], tuple):
        t, n_cam = len(imgs_list), imgs_list[0][0].shape[0]
    else:
        t, n_cam = np.shape(imgs_list)[:2]
    color, depth = process_imgs(imgs_list)
    episode = {
        "info": {"n_cams": n_cam, "timestamp": t,
                 "n_particles": particles.shape[1]},
        "action": np.asarray(action),
        "positions": particles.astype(np.float32),
        "eef_states": eefs.astype(np.float32),
        "observations": {"color": color, "depth": depth},
    }
    save_data(filename, episode)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def save_data(filename: str, episode: dict):
    """Write an episode's nested dict as one compressed archive whose keys
    are the h5 dataset paths ('observations/color/cam_0', ...)."""
    with open(filename, "wb") as f:
        np.savez_compressed(f, **_flatten(episode))


def load_data(filename: str) -> dict:
    """The nested dict of an episode written by save_data: the JAX
    package's load_data's form (scalars as numpy scalars, as h5py reads
    them)."""
    out = {}
    with np.load(filename) as z:
        for path in z.files:
            *parents, leaf = path.split("/")
            node = out
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = z[path][()]
    return out


def save_property_params(epi_dir: str, props: dict):
    with open(os.path.join(epi_dir, "property_params.pkl"), "wb") as f:
        pickle.dump(props, f)


def load_property_params(epi_dir: str) -> dict:
    """The property params an episode's generator wrote (a pickle: read
    only files this pipeline wrote)."""
    with open(os.path.join(epi_dir, "property_params.pkl"), "rb") as f:
        return pickle.load(f)
