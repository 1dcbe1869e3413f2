"""Graph-neural-network dynamics model: the port of
adaptigraph_tpu/dynamics/model.py (flax) as torch modules.

Node features are attrs (+ optional state history) + per-object physics
params + action; edge features are receiver/sender attrs, the instance
group difference and the history of position differences; three 3-layer
ReLU encoders; `pstep` rounds of message passing over a fixed-size edge
list (ops.EdgeSet); a 3-layer motion head clamped to +-motion_clamp and
added to the last observed position.

The forward takes a leading batch dimension natively (JAX vmaps its
single-graph apply): state (B, n_his, N, 3), attrs (B, N, attr_dim), edges
(B, E), p_instance (B, N_obj, n_instance), physics_param (B, phys_dim),
action (B, N, 3). Padded edges (receiver = sender = 0) are multiplied out
by the valid mask before every sum, as in JAX, so in no aggregation mode
do they leak into node 0.

The four aggregation modes share one parameter set (ModelConfig): 'matmul'
gathers and aggregates by one-hot incidence products, 'segment' by index
gathers and a scatter-add (atomics on CUDA, so its last bits may vary from
run to run), 'slotted' takes edges from build_edges_slotted (slot row i
belongs to receiver i: receiver gathers become broadcasts, aggregation a
sum over slots) and 'slotmm' is 'slotted' with the sender gather as a
one-hot product. Any other value takes the 'segment' path, as in JAX.

Compute runs in float32 (TF32 off) or bfloat16 with float32 parameters:
each dense layer casts its input, weight and bias to the compute dtype, as
flax's Dense(dtype=bfloat16) does, and the state itself is cast, so the
predicted position is formed in the compute dtype before the cast to
float32. Module and parameter names are flax's (`particle_encoder.Dense_0`
and so on), and `params_from_jax` carries a flax parameter tree across.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaptigraph_torch.utils.device import full_f32_matmul, resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    n_his: int = 4
    nf: int = 150  # nf_particle == nf_relation == nf_effect (config model_config)
    pstep: int = 3
    attr_dim: int = 2
    state_dim: int = 0  # rope/granular/cloth configs use 0
    action_dim: int = 3
    density_dim: int = 0
    phys_dim: int = 1  # material physics-param dim (1 for all three materials)
    rel_particle_dim: int = 0
    rel_attr_dim: int = 2
    rel_group_dim: int = 1
    rel_distance_dim: int = 3
    rel_density_dim: int = 0
    motion_clamp: float = 100.0
    compute_dtype: torch.dtype = torch.float32
    aggregation: str = "matmul"

    @property
    def particle_in(self) -> int:
        """Width of the particle encoder's input (flax infers it)."""
        return (self.attr_dim + (self.n_his * 3 if self.state_dim > 0 else 0)
                + self.phys_dim + self.action_dim
                + (1 if self.density_dim > 0 else 0))

    @property
    def relation_in(self) -> int:
        """Width of the relation encoder's input: receiver and sender
        particle inputs and attrs, the group difference, the history
        differences."""
        return ((2 * self.particle_in if self.rel_particle_dim > 0 else 0)
                + (2 * self.attr_dim if self.rel_attr_dim > 0 else 0)
                + (1 if self.rel_group_dim > 0 else 0)
                + (self.n_his * 3 if self.rel_distance_dim > 0 else 0))

    def layer_shapes(self) -> Dict[str, tuple]:
        """(in, out) of every dense layer, by its flax path."""
        nf = self.nf
        shapes = {}
        for name, width in (("particle_encoder", self.particle_in),
                            ("relation_encoder", self.relation_in)):
            for i, w_in in enumerate((width, nf, nf)):
                shapes[f"{name}.Dense_{i}"] = (w_in, nf)
        shapes["relation_propagator.Dense_0"] = (3 * nf, nf)
        shapes["particle_propagator.Dense_0"] = (2 * nf, nf)
        for i, (w_in, w_out) in enumerate(((nf, nf), (nf, nf), (nf, 3))):
            shapes[f"non_rigid_predictor.Dense_{i}"] = (w_in, w_out)
        return shapes


def _trunc_normal_(w: torch.Tensor, std: float, generator) -> None:
    """w ~ normal(0, std) truncated to +-2 std, drawn on the CPU from
    `generator` (so the draw is the same whatever w's device), by the
    inverse CDF as torch.nn.init.trunc_normal_ draws it."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (
        1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.empty(w.shape, dtype=torch.float32)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    x = torch.erfinv(u).mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
    w.copy_(x)


class _Dense(nn.Module):
    """flax's Dense: weight (out, in), bias (out,); input, weight and bias
    cast to the compute dtype."""

    def __init__(self, n_in: int, n_out: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((n_out, n_in), device=device))
        self.bias = nn.Parameter(torch.zeros((n_out,), device=device))

    def forward(self, x):
        dt = x.dtype
        return F.linear(x, self.weight.to(dt), self.bias.to(dt))


class _Encoder(nn.Module):
    """3-layer MLP, ReLU after every layer (gnn/model.py:4-21)."""

    def __init__(self, n_in: int, nf: int, out: int, device):
        super().__init__()
        self.Dense_0 = _Dense(n_in, nf, device)
        self.Dense_1 = _Dense(nf, nf, device)
        self.Dense_2 = _Dense(nf, out, device)

    def forward(self, x):
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return F.relu(self.Dense_2(x))


class _Propagator(nn.Module):
    """Linear + residual + ReLU (gnn/model.py:23-41)."""

    def __init__(self, n_in: int, out: int, device):
        super().__init__()
        self.Dense_0 = _Dense(n_in, out, device)

    def forward(self, x, res=None):
        x = self.Dense_0(x)
        if res is not None:
            x = x + res
        return F.relu(x)


class _MotionHead(nn.Module):
    """3-layer MLP, no activation on the output (gnn/model.py:43-60)."""

    def __init__(self, nf: int, device):
        super().__init__()
        self.Dense_0 = _Dense(nf, nf, device)
        self.Dense_1 = _Dense(nf, nf, device)
        self.Dense_2 = _Dense(nf, 3, device)

    def forward(self, x):
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class DynamicsPredictor(nn.Module):
    """The dynamics model, on `device` (CUDA unless given), its weights
    drawn as flax's default init draws them (a fan-in truncated normal,
    zero bias) from `generator` (a CPU torch.Generator; a fixed seed of 0
    when None)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        if cfg.rel_density_dim > 0:
            raise ValueError(
                "rel_density_dim > 0 has no defined input: particle_den is "
                "one value per graph in the reference model")
        device = resolve_device(device)
        full_f32_matmul()
        self.cfg = cfg
        nf = cfg.nf
        self.particle_encoder = _Encoder(cfg.particle_in, nf, nf, device)
        self.relation_encoder = _Encoder(cfg.relation_in, nf, nf, device)
        self.relation_propagator = _Propagator(3 * nf, nf, device)
        self.particle_propagator = _Propagator(2 * nf, nf, device)
        self.non_rigid_predictor = _MotionHead(nf, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, (w_in, _) in cfg.layer_shapes().items():
                layer = self.get_submodule(name)
                _trunc_normal_(layer.weight, 1.0 / math.sqrt(w_in)
                               / .87962566103423978, generator)

    def forward(self, state, attrs, recv, send, edge_valid, p_instance,
                physics_param, action=None, particle_den=None, obj_mask=None,
                **unused):
        """One-step dynamics prediction of B graphs.

        Args: state (B, n_his, N, 3) padded history (objects then eef);
        attrs (B, N, attr_dim); recv / send / edge_valid (B, E) edge lists;
        p_instance (B, N_obj, n_instance); physics_param (B, phys_dim);
        action (B, N, 3) per-node action (eef delta rows); particle_den (B,)
        when density_dim > 0; obj_mask is accepted and unused, as in JAX.

        Returns (pred_pos (B, N_obj, 3), pred_motion (B, N_obj, 3)),
        float32."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, n_his, n, _ = state.shape
        n_obj = p_instance.shape[1]
        dev = state.device

        state = state.to(dt)
        # history features: residuals then current position (the
        # reference's gnn/model.py:154-165)
        state_res = state[:, 1:] - state[:, :-1]
        state_feat = torch.cat([state_res, state[:, -1:]], dim=1)
        state_feat = state_feat.transpose(1, 2).reshape(b, n, n_his * 3)

        attrs = attrs.to(dt)
        p_in = [attrs]
        if cfg.state_dim > 0:
            p_in.append(state_feat)
        # physics params broadcast to object particles, zero on eef rows
        # (the reference's gnn/model.py:184-190)
        is_obj = (torch.arange(n, device=dev) < n_obj)[None, :, None]
        phys = physics_param.to(dt)[:, None, :].expand(b, n, -1)
        p_in.append(torch.where(is_obj, phys, torch.zeros_like(phys)))
        if cfg.action_dim > 0:
            p_in.append(action.to(dt))
        if cfg.density_dim > 0:
            den = particle_den.to(dt).reshape(b, 1, 1).expand(b, n, 1)
            p_in.append(torch.where(is_obj, den, torch.zeros_like(den)))
        p_inputs = torch.cat(p_in, dim=-1)

        gather_rs, aggregate = _aggregation(cfg.aggregation, recv, send, n,
                                            dt)

        # ---- edge features (the reference's gnn/model.py:209-265) ----
        ev = edge_valid.to(dt)[..., None]
        nodes = []  # node tables gathered at both ends, side by side
        if cfg.rel_particle_dim > 0:
            nodes.append(p_inputs)
        if cfg.rel_attr_dim > 0:
            nodes.append(attrs)
        if cfg.rel_group_dim > 0:
            g = p_instance.to(dt)
            nodes.append(torch.cat(
                [g, g.new_zeros((b, n - n_obj, g.shape[-1]))], dim=1))
        if cfg.rel_distance_dim > 0:
            nodes.append(state_feat)
        widths = [x.shape[-1] for x in nodes]
        at_r, at_s = (torch.split(x, widths, dim=-1)
                      for x in gather_rs(torch.cat(nodes, dim=-1)))
        rel_in, k = [], 0
        if cfg.rel_particle_dim > 0:
            rel_in += [at_r[k], at_s[k]]
            k += 1
        if cfg.rel_attr_dim > 0:
            rel_in += [at_r[k], at_s[k]]
            k += 1
        if cfg.rel_group_dim > 0:
            rel_in.append((at_r[k] - at_s[k]).abs().sum(-1, keepdim=True))
            k += 1
        if cfg.rel_distance_dim > 0:
            rel_in.append(at_r[k] - at_s[k])
        rel_inputs = torch.cat(rel_in, dim=-1) * ev

        node_enc = self.particle_encoder(p_inputs)
        edge_enc = self.relation_encoder(rel_inputs) * ev

        effect = node_enc
        for _ in range(cfg.pstep):
            e_r, e_s = gather_rs(effect)
            edge_effect = self.relation_propagator(
                torch.cat([edge_enc, e_r, e_s], dim=-1)) * ev
            agg = aggregate(edge_effect)
            effect = self.particle_propagator(
                torch.cat([node_enc, agg], dim=-1), res=effect)

        motion = self.non_rigid_predictor(effect[:, :n_obj])
        motion = torch.clamp(motion, -cfg.motion_clamp, cfg.motion_clamp)
        pred_pos = state[:, -1, :n_obj] + motion
        return pred_pos.to(torch.float32), motion.to(torch.float32)


def _aggregation(mode: str, recv, send, n: int, dt):
    """(gather_rs, aggregate) of an aggregation mode: gather_rs(x) gives
    node table x (B, N, F) at every edge's receiver and sender, (B, E, F)
    each; aggregate(e) sums edge values (B, E, F) into their receivers."""
    b, n_edges = recv.shape
    dev = recv.device
    recv, send = recv.long(), send.long()
    if mode == "matmul":
        # one-hot incidence, receivers then senders, built once a forward
        rrs = F.one_hot(torch.cat([recv, send], dim=1), n).to(dt)
        rr = rrs[:, :n_edges]

        def gather_rs(x):
            both = torch.bmm(rrs, x)
            return both[:, :n_edges], both[:, n_edges:]

        def aggregate(e):
            return torch.bmm(rr.transpose(1, 2), e)
        return gather_rs, aggregate

    base = (torch.arange(b, device=dev) * n)[:, None]
    flat_send = (send + base).reshape(-1)

    def take(x, flat_idx):
        return x.reshape(b * n, -1).index_select(0, flat_idx).reshape(
            b, -1, x.shape[-1])

    if mode in ("slotted", "slotmm"):
        # slot row i holds receiver i's candidates: receiver values
        # broadcast over its slots, aggregation is a sum over them
        if n_edges % n != 0:
            raise ValueError(
                "slotted aggregation requires edges from build_edges_slotted "
                f"(E={n_edges} not a multiple of N={n})")
        s = n_edges // n
        if mode == "slotmm":
            rs = F.one_hot(send, n).to(dt)

            def sender(x):
                return torch.bmm(rs, x)
        else:
            def sender(x):
                return take(x, flat_send)

        def gather_rs(x):
            at_r = x[:, :, None, :].expand(b, n, s, x.shape[-1])
            return at_r.reshape(b, n_edges, -1), sender(x)

        def aggregate(e):
            return e.reshape(b, n, s, -1).sum(dim=2)
        return gather_rs, aggregate

    flat_recv = (recv + base).reshape(-1)
    flat_both = torch.cat([(recv + base), (send + base)], dim=1).reshape(-1)

    def gather_rs(x):
        both = take(x, flat_both).reshape(b, 2, n_edges, -1)
        return both[:, 0], both[:, 1]

    def aggregate(e):
        out = e.new_zeros((b * n, e.shape[-1]))
        out.index_add_(0, flat_recv, e.reshape(b * n_edges, -1))
        return out.reshape(b, n, -1)
    return gather_rs, aggregate


def model_config_from_yaml(model_cfg: Mapping, dataset_cfg: Mapping,
                           phys_dim: int) -> ModelConfig:
    """A ModelConfig from the reference-style yaml blocks.

    `aggregation` may be set in the model block or overridden with
    ADAPTIGRAPH_GNN_AGG (the modes share parameters); 'slotted' and
    'slotmm' need slot-layout edges, which the rollout evaluator then
    builds. `compute_dtype` may be overridden with ADAPTIGRAPH_GNN_DTYPE
    (f32 | bf16); parameters stay float32."""
    agg = os.environ.get("ADAPTIGRAPH_GNN_AGG",
                         model_cfg.get("aggregation", "matmul"))
    dt_name = os.environ.get("ADAPTIGRAPH_GNN_DTYPE",
                             model_cfg.get("compute_dtype", "f32"))
    dtype = torch.bfloat16 if dt_name in ("bf16", "bfloat16") else torch.float32
    return ModelConfig(
        aggregation=agg,
        compute_dtype=dtype,
        n_his=int(dataset_cfg["n_his"]),
        nf=int(model_cfg.get("nf_effect", 150)),
        pstep=int(model_cfg.get("pstep", 3)),
        attr_dim=int(model_cfg.get("attr_dim", 2)),
        state_dim=int(model_cfg.get("state_dim", 0)),
        action_dim=int(model_cfg.get("action_dim", 3)),
        density_dim=int(model_cfg.get("density_dim", 0)),
        phys_dim=phys_dim,
        rel_particle_dim=int(model_cfg.get("rel_particle_dim", 0)),
        rel_attr_dim=int(model_cfg.get("rel_attr_dim", 2)),
        rel_group_dim=int(model_cfg.get("rel_group_dim", 1)),
        rel_distance_dim=int(model_cfg.get("rel_distance_dim", 3)),
        rel_density_dim=int(model_cfg.get("rel_density_dim", 0)),
    )


def params_from_jax(params: Mapping, cfg: ModelConfig) -> "OrderedDict":
    """The state_dict of a DynamicsPredictor from a flax parameter tree:
    nested dicts of numpy arrays ({'particle_encoder': {'Dense_0':
    {'kernel': (in, out), 'bias': (out,)}}, ...}, as orbax restores it).
    Each kernel (in, out) becomes a weight (out, in). Every layer's shape
    is checked against the widths `cfg` gives; a missing, extra or
    misshapen array raises ValueError."""
    expected = cfg.layer_shapes()
    found = {f"{m}.{d}" for m, layers in params.items() for d in layers}
    if found != set(expected):
        raise ValueError(f"flax layers {sorted(found)} are not the model's "
                         f"{sorted(expected)}")
    out = OrderedDict()
    for name, (w_in, w_out) in expected.items():
        module, dense = name.split(".")
        leaf = params[module][dense]
        if set(leaf) != {"kernel", "bias"}:
            raise ValueError(f"{name} holds {sorted(leaf)}")
        kernel = np.asarray(leaf["kernel"], np.float32)
        bias = np.asarray(leaf["bias"], np.float32)
        if kernel.shape != (w_in, w_out) or bias.shape != (w_out,):
            raise ValueError(
                f"{name}: kernel {kernel.shape}, bias {bias.shape}; the "
                f"config gives ({w_in}, {w_out}) and ({w_out},)")
        out[f"{name}.weight"] = torch.from_numpy(kernel.T.copy())
        out[f"{name}.bias"] = torch.from_numpy(bias.copy())
    return out
