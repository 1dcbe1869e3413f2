"""Episode property params: the port of the pickle pair of
adaptigraph_tpu/sim/episode_io.py (save_property_params,
load_property_params). The h5 episode functions wait for the
data-generation slice, which settles an episode form the port can write
without h5py."""

from __future__ import annotations

import os
import pickle


def save_property_params(epi_dir: str, props: dict):
    with open(os.path.join(epi_dir, "property_params.pkl"), "wb") as f:
        pickle.dump(props, f)


def load_property_params(epi_dir: str) -> dict:
    """The property params an episode's generator wrote (a pickle: read
    only files this pipeline wrote)."""
    with open(os.path.join(epi_dir, "property_params.pkl"), "rb") as f:
        return pickle.load(f)
