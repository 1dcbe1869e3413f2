"""GNN dynamics training: so far the model's apply and its init, the port
of `make_apply` and `init_model` of adaptigraph_tpu/dynamics/train.py.

The training loop (the unrolled multi-step loss, Adam, checkpoints) and the
on-device graph preparation it feeds on come with the training slice.
Checkpoints of the JAX package (orbax) are read on the JAX side and
carried across by `dynamics.model.params_from_jax`.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from adaptigraph_torch.dynamics.model import (DynamicsPredictor,
                                              model_config_from_yaml)
from adaptigraph_torch.utils.device import resolve_device


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
