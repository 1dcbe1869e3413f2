"""Port parity: the GNN dynamics model against the JAX package's flax
model, the flax weights carried across by params_from_jax.

Cases and tolerances (the maxima measured on the CPU beside each):
- each aggregation mode at nf 32, pstep 2 (the JAX tests' size,
  tests/test_dynamics.py:38) on two graphs at once: positions and motions
  within 1e-5 (4.8e-7 matmul and segment, 7.2e-7 slotted and slotmm, on
  motions up to 2.3);
- __graft_entry__'s full-width toy batch (B 8, 100 objects and a tool
  point, 1,000 edges, nf 150, pstep 3, random weights): the entry's
  forward within 1e-5 (9.5e-6: its predictions reach 15, where 1e-5 is
  ten float32 ulps; JAX itself is 5.7e-6 from a float64 forward), and the
  port's build_edges_batch gives the batch's edges exactly;
- bfloat16 compute against JAX's bfloat16 forward: the deviation over the
  f32 motion's scale below the JAX tests' bounds, 0.05 at nf 64
  (tests/test_bf16.py:28) and 0.08 at nf 150 (tests/test_dynamics.py:279)
  (the motions equal JAX's bf16 motions to the bit and the positions
  differ from JAX's bf16 ones by 0.0050 and 0.0034 of that scale; 0.0071
  and 0.0066 against JAX's f32 motions);
- the rope checkpoint, restored by JAX's load_checkpoint and carried
  across: loads strictly and matches JAX's forward on the toy batch within
  1e-5 (1.0e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from adaptigraph_tpu.dynamics.model import DynamicsPredictor as JModel
from adaptigraph_tpu.dynamics.model import ModelConfig as JConfig
from adaptigraph_tpu.dynamics.train import load_checkpoint
from adaptigraph_tpu.ops import build_edges as j_build_edges
from adaptigraph_tpu.ops import build_edges_slotted as j_build_slotted
from adaptigraph_torch.dynamics import DynamicsPredictor, ModelConfig
from adaptigraph_torch.dynamics.model import params_from_jax
from adaptigraph_torch.dynamics.train import init_model, make_apply
from adaptigraph_torch.ops import build_edges_batch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ATOL = 1e-5
_KEYS = ("state", "attrs", "recv", "send", "edge_valid", "p_instance",
         "physics_param")


def _graph(seed, n_obj=20, n_eef=1, n_his=4, slotted=False, max_nR=100,
           topk=10):
    """One toy graph of numpy arrays, its edges from the JAX builder."""
    rng = np.random.RandomState(seed)
    n = n_obj + n_eef
    state = (rng.randn(n_his, n, 3) * 0.3).astype(np.float32)
    attrs = np.zeros((n, 2), np.float32)
    attrs[:n_obj, 0] = 1.0
    attrs[n_obj:, 1] = 1.0
    mask = np.ones(n, bool)
    tool = np.zeros(n, bool)
    tool[n_obj:] = True
    if slotted:
        e = j_build_slotted(jnp.asarray(state[-1]), 1.0, jnp.asarray(mask),
                            jnp.asarray(tool), topk=topk)
    else:
        e = j_build_edges(jnp.asarray(state[-1]), 1.0, jnp.asarray(mask),
                          jnp.asarray(tool), topk=topk, max_edges=max_nR)
    action = np.zeros((n, 3), np.float32)
    action[n_obj:] = rng.randn(n_eef, 3) * 0.1
    return {"state": state, "attrs": attrs, "recv": np.asarray(e.receivers),
            "send": np.asarray(e.senders), "edge_valid": np.asarray(e.valid),
            "p_instance": np.ones((n_obj, 1), np.float32),
            "physics_param": np.array([0.5], np.float32), "action": action,
            "obj_mask": np.ones(n_obj, bool)}


def _stack(graphs):
    return {k: np.stack([g[k] for g in graphs]) for k in graphs[0]}


def _jax_forward(model, params, batch):
    def one(g):
        return model.apply({"params": params}, *(g[k] for k in _KEYS),
                           action=g["action"])

    pred, motion = jax.jit(jax.vmap(one))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(pred), np.asarray(motion)


def _jax_init(cfg, g, seed=1):
    init = jax.jit(JModel(cfg).init)
    return init(jax.random.PRNGKey(seed), *(jnp.asarray(g[k]) for k in _KEYS),
                action=jnp.asarray(g["action"]))["params"]


def _port(cfg, jparams, dtype=torch.float32, **over):
    tcfg = ModelConfig(n_his=cfg.n_his, nf=cfg.nf, pstep=cfg.pstep,
                       aggregation=cfg.aggregation, compute_dtype=dtype,
                       **over)
    model = DynamicsPredictor(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg), strict=True)
    return model


def _port_forward(model, batch):
    t = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
    with torch.no_grad():
        pred, motion = model(*(t[k] for k in _KEYS), action=t["action"],
                             obj_mask=t["obj_mask"])
    return pred.numpy(), motion.numpy()


@pytest.mark.parametrize("mode", ["matmul", "segment", "slotted", "slotmm"])
def test_each_aggregation_mode_matches_jax(mode):
    slotted = mode in ("slotted", "slotmm")
    batch = _stack([_graph(s, slotted=slotted) for s in (3, 4)])
    cfg = JConfig(n_his=4, nf=32, pstep=2, aggregation=mode)
    g0 = {k: v[0] for k, v in batch.items()}
    jparams = _jax_init(cfg, g0)
    jp, jm = _jax_forward(JModel(cfg), jparams, batch)
    tp, tm = _port_forward(_port(cfg, jparams), batch)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=_ATOL)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=_ATOL)
    assert np.abs(jm).max() > 1e-3  # the model moves the nodes


@pytest.fixture(scope="module")
def entry():
    fwd, (params, batch) = graft.entry()
    batch = {k: np.asarray(v) for k, v in batch.items()}
    return fwd, params, batch


def test_entry_full_width_batch_matches_jax(entry):
    fwd, params, batch = entry
    jp = np.asarray(jax.jit(fwd)(params, batch))
    model = _port(JConfig(n_his=4, nf=150, pstep=3), params)
    tp, _ = _port_forward(model, batch)
    assert tp.shape == (8, 100, 3)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=_ATOL)
    # the entry's edges, from the port's batch builder on the same states
    n_obj = 100
    tool = np.zeros((8, 101), bool)
    tool[:, n_obj:] = True
    last = torch.as_tensor(np.array(batch["state"][:, -1]))
    e = build_edges_batch(last, 0.5, torch.ones((8, 101), dtype=torch.bool),
                          torch.as_tensor(tool), topk=10, max_edges=1000)
    assert np.array_equal(e.receivers.numpy(), batch["recv"])
    assert np.array_equal(e.senders.numpy(), batch["send"])
    assert np.array_equal(e.valid.numpy(), batch["edge_valid"])


def test_single_graph_apply_is_the_batched_forward(entry):
    _, params, batch = entry
    model = _port(JConfig(n_his=4, nf=150, pstep=3), params)
    apply = make_apply(model)
    g = {k: torch.as_tensor(np.array(v[2])) for k, v in batch.items()}
    with torch.no_grad():
        pred, motion = apply(dict(model.state_dict()), g)
    bp, bm = _port_forward(model, batch)
    # a product over one graph blocks its sums otherwise than over eight
    np.testing.assert_allclose(pred.numpy(), bp[2], rtol=0, atol=_ATOL)
    np.testing.assert_allclose(motion.numpy(), bm[2], rtol=0, atol=_ATOL)


@pytest.mark.parametrize("nf, pstep, mode, bound", [
    (64, 2, "matmul", 0.05),  # tests/test_bf16.py
    (150, 3, "slotted", 0.08),  # tests/test_dynamics.py
])
def test_bf16_within_the_jax_bound(nf, pstep, mode, bound):
    slotted = mode == "slotted"
    n_obj = 40 if slotted else 20
    batch = _stack([_graph(7, n_obj=n_obj, slotted=slotted, topk=6)])
    cfg32 = JConfig(n_his=4, nf=nf, pstep=pstep, aggregation=mode)
    jparams = _jax_init(cfg32, {k: v[0] for k, v in batch.items()})
    _, jm32 = _jax_forward(JModel(cfg32), jparams, batch)
    cfg16 = JConfig(n_his=4, nf=nf, pstep=pstep, aggregation=mode,
                    compute_dtype=jnp.bfloat16)
    jp16, jm16 = _jax_forward(JModel(cfg16), jparams, batch)
    tp16, tm16 = _port_forward(_port(cfg32, jparams, torch.bfloat16), batch)
    assert tp16.dtype == np.float32
    scale = float(np.abs(jm32).max()) + 1e-6
    assert float(np.abs(tm16 - jm16).max()) / scale < bound
    assert float(np.abs(tm16 - jm32).max()) / scale < bound
    assert float(np.abs(tp16 - jp16).max()) / scale < bound


def test_slotted_rejects_an_edge_count_not_a_multiple_of_n():
    batch = _stack([_graph(0, max_nR=97)])
    cfg = JConfig(n_his=4, nf=32, pstep=2, aggregation="slotted")
    model = DynamicsPredictor(ModelConfig(n_his=4, nf=32, pstep=2,
                                          aggregation="slotted"),
                              device="cpu")
    with pytest.raises(ValueError, match="not a multiple"):
        _port_forward(model, batch)
    with pytest.raises(AssertionError):
        _jax_init(cfg, {k: v[0] for k, v in batch.items()})


def test_rope_checkpoint_carried_across(entry):
    fwd, params_like, batch = entry
    ckpt = os.path.join(_ROOT, "data", "log", "rope", "checkpoints")
    restored = load_checkpoint(ckpt, "latest", params_like)
    jp = np.asarray(jax.jit(fwd)(restored, batch))
    tcfg = ModelConfig(n_his=4, nf=150, pstep=3)
    sd = params_from_jax(jax.tree.map(np.asarray, restored), tcfg)
    assert sd["particle_encoder.Dense_0.weight"].shape == (150, 6)
    assert sd["relation_encoder.Dense_0.weight"].shape == (150, 17)
    model = DynamicsPredictor(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    tp, _ = _port_forward(model, batch)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=_ATOL)
    # a checkpoint of other widths is refused, layer by layer
    narrow = ModelConfig(n_his=3, nf=150, pstep=3)
    with pytest.raises(ValueError, match="relation_encoder.Dense_0"):
        params_from_jax(jax.tree.map(np.asarray, restored), narrow)


def test_init_follows_flax_default_init():
    """Fan-in truncated normal weights (within 2 std, std 1/sqrt(fan_in)
    before truncation), zero biases, the same draw for the same seed."""
    cfg = {"model_config": {"nf_effect": 150, "pstep": 3},
           "dataset_config": {"n_his": 4}, "train_config": {}}
    phys = type("Dataset", (), {"phys_dim": 1})()
    model, params = init_model(cfg, phys, device="cpu")
    _, again = init_model(cfg, phys, device="cpu")
    other, _ = init_model(cfg, phys, device="cpu",
                          generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(params[k], again[k]) for k in params)
    w = params["relation_propagator.Dense_0.weight"]
    assert not torch.equal(w, other.relation_propagator.Dense_0.weight)
    for name, (w_in, _) in model.cfg.layer_shapes().items():
        std = 1.0 / np.sqrt(w_in) / 0.87962566103423978
        wt = params[f"{name}.weight"]
        assert float(wt.abs().max()) <= 2 * std + 1e-7
        if wt.numel() > 1000:
            assert abs(float(wt.std()) / (std * 0.8796) - 1) < 0.1
        assert not params[f"{name}.bias"].any()


def test_model_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DynamicsPredictor(ModelConfig(nf=8, pstep=1))
    cfg = {"model_config": {}, "dataset_config": {"n_his": 4},
           "train_config": {}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg, type("Dataset", (), {"phys_dim": 1})())
