"""Port parity: the planning slice (actions, costs, the batched population
rollout, the MPPI and GD planner, the optimisers and the online
physics-parameter estimate) against the JAX package on the CPU.

Inputs come from numpy seeds; JAX's random draws are replayed through
the port's explicit draws (the same key splits as the JAX planner).
Tolerances, with the maxima measured on the CPU:
- decode: repeats exactly, segment ends within 1e-7 (XLA's and torch's
  cos and sin differ by an ulp: 7.5e-9); clip and the angle wrap exactly;
  proposals from JAX's draws within 1e-6 (4.8e-7); the MPPI update within
  1e-5;
- penalties, error functions and rewards within 1e-5, chunked or not; a
  chunked cloth population differs from its unchunked self exactly as
  JAX's does (the per-chunk normalisation both keep);
- batched rollouts (nf 16, pstep 1, the JAX tests' model) within 1e-5 of
  JAX's, on the rope, granular (5-point board) and cloth (gripper) task
  configs; chunked populations equal to unchunked ones bit for bit;
  masks that leave rows out of the population (holes, per-sample masks,
  fewer rows than topk; the port runs the rows held and scatters back)
  within 1e-5 of JAX's full-width rollout, and so is their gradient;
- the rope checkpoint carried across by params_from_jax: the masked
  replay of the 15 logged interactions of data/plan_rope and the
  optimiser's dynamics error at physics params 0.2, 0.5 and 0.8 within
  1e-5; one MPPI step (12 samples in chunks of 5, 2 iterations) on
  interaction_000's state and the recorded target: every reward within
  1e-5 and the same chosen action;
- the optimisers' numpy copy equal to JAX's; one GD step's gradient and
  Adam update within 1e-5 of jax.value_and_grad and optax.adam.
The graphs use max_nobj 32 (the rope checkpoint's tests) or up to 30
objects, so that the file stays well under a minute on one worker.
"""

import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptigraph_tpu.dynamics.model import DynamicsPredictor as JModel
from adaptigraph_tpu.dynamics.model import ModelConfig as JConfig
from adaptigraph_tpu.dynamics.model import (
    model_config_from_yaml as j_model_config)
from adaptigraph_tpu.dynamics.train import load_checkpoint
from adaptigraph_tpu.ops import build_edges_slotted as j_slotted
from adaptigraph_tpu.ops import chamfer as j_chamfer
from adaptigraph_tpu.planning import actions as ja
from adaptigraph_tpu.planning import costs as jc
from adaptigraph_tpu.planning import forward_dynamics as jf
from adaptigraph_tpu.planning import optim as jo
from adaptigraph_tpu.planning.physics_optimizer import (
    PhysicsParamOnlineOptimizer as JOptimizer)
from adaptigraph_tpu.planning.planner import Planner as JPlanner
from adaptigraph_tpu.utils import load_config as j_load_config
from adaptigraph_torch.dynamics import DynamicsPredictor, ModelConfig
from adaptigraph_torch.dynamics.model import (model_config_from_yaml,
                                              params_from_jax)
from adaptigraph_torch.ops import chamfer as t_chamfer
from adaptigraph_torch.planning import actions as ta
from adaptigraph_torch.planning import costs as tc
from adaptigraph_torch.planning import forward_dynamics as tf
from adaptigraph_torch.planning import optim as to
from adaptigraph_torch.planning.demo import run_demo
from adaptigraph_torch.planning.physics_optimizer import (
    PhysicsParamOnlineOptimizer as TOptimizer)
from adaptigraph_torch.planning.planner import Planner as TPlanner
from adaptigraph_torch.utils import load_config as t_load_config

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PLAN_ROPE = os.path.join(_ROOT, "data", "plan_rope")
_ATOL = 1e-5
LOWER = np.array([-4.5, -2.5, -3.14, 2.0], np.float32)
UPPER = np.array([0.0, 4.5, 3.14, 10.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores, and
    torch's thread pools, each sized to every core, slow each other down
    many times over (the numbers compared do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _j(x):
    return jnp.asarray(np.asarray(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(t, j, atol=_ATOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=atol)


def jax_draws(seed):
    """The port's noise_fn replaying the JAX MPPI planner's key splits
    (planner.py:74-76 with actions.py:58,68-70)."""
    key = [jax.random.PRNGKey(seed)]

    def draw(i, n_sample, n_look, adim):
        key[0], sub = jax.random.split(key[0])
        if i == 0:
            return _t(jax.random.uniform(sub, (n_sample, n_look, adim)))
        keys = jax.random.split(sub, n_look)
        return _t(np.stack([np.asarray(jax.random.normal(k, (n_sample, 4)))
                            for k in keys]))
    return draw


# ---------------------------------------------------------------- actions


def _actions(seed, shape=(40, 3)):
    rng = np.random.RandomState(seed)
    a = np.concatenate([rng.uniform(-5, 5, shape + (2,)),
                        rng.uniform(-10, 10, shape + (1,)),
                        rng.uniform(-1, 16, shape + (1,))], -1)
    return a.astype(np.float32)


def test_decode_equals_jax():
    a = _actions(0)
    dj, rj = ja.decode_action(_j(a), 0.1)
    dt, rt = ta.decode_action(_t(a), 0.1)
    assert rt.dtype == torch.int32
    np.testing.assert_array_equal(_np(rt), _np(rj))
    np.testing.assert_array_equal(_np(dt)[..., :2], _np(dj)[..., :2])
    _close(dt, dj, atol=1e-7)
    for row in a.reshape(-1, 4)[:10]:
        row = row.copy()
        row[3] = abs(row[3])
        assert ta.decode_action_single(row, 0.2) == ja.decode_action_single(
            row, 0.2)


def test_clip_and_angle_wrap_equal_jax():
    a = _actions(1)
    np.testing.assert_array_equal(
        _np(ta.angle_normalize(_t(a[..., 2]))),
        _np(ja.angle_normalize(_j(a[..., 2]))))
    np.testing.assert_array_equal(
        _np(ta.clip_actions(_t(a), _t(LOWER), _t(UPPER))),
        _np(ja.clip_actions(_j(a), _j(LOWER), _j(UPPER))))


@pytest.mark.parametrize("iter_index", [0, 1])
def test_proposals_from_jax_draws(iter_index):
    inc = np.array([[-2.0, 1.0, 0.5, 4.0], [-1.0, 0.3, -2.0, 9.0]],
                   np.float32)
    draw = jax_draws(7)
    for i in range(iter_index + 1):
        draws = draw(i, 64, 2, 4)
    key = jax.random.split(jax.random.PRNGKey(7))[1]
    if iter_index:
        key = jax.random.split(jax.random.split(jax.random.PRNGKey(7))[0])[1]
    sj = ja.sample_action_seq(_j(inc), _j(LOWER), _j(UPPER), 64, key,
                              iter_index=iter_index, noise_level=1.0)
    st = ta.sample_action_seq(_t(inc), _t(LOWER), _t(UPPER), 64, draws,
                              iter_index=iter_index, noise_level=1.0)
    assert st.shape == (64, 2, 4)
    _close(st, sj, atol=1e-6)
    if iter_index:  # sample 0 is the incumbent, exactly
        np.testing.assert_array_equal(_np(st[0]), inc)
        assert float((st[1:] - _t(inc)).abs().max()) > 1e-3
    else:
        assert bool((st >= _t(LOWER)).all() and (st <= _t(UPPER)).all())


def test_mppi_update_equals_jax():
    rng = np.random.RandomState(2)
    seqs = _actions(3, (64, 2))
    seqs[..., 3] = np.abs(seqs[..., 3])
    rewards = rng.randn(64).astype(np.float32) * 0.01
    oj = ja.optimize_action_mppi(_j(seqs), _j(rewards), 500.0, _j(LOWER),
                                 _j(UPPER))
    ot = ta.optimize_action_mppi(_t(seqs), _t(rewards), 500.0, _t(LOWER),
                                 _t(UPPER))
    assert ot.shape == (2, 4)
    _close(ot, oj)
    # a dominant reward takes the update to its sample
    acts = _t([[[-3.0, 0.0, 0.0, 4.0]], [[-1.0, 2.0, 1.0, 6.0]]])
    out = ta.optimize_action_mppi(acts, _t([-10.0, 10.0]), 100.0,
                                  _t(LOWER), _t(UPPER))
    _close(out, acts[1], atol=1e-3)


def test_draw_action_noise_from_a_generator():
    def draws(i):
        g = torch.Generator().manual_seed(5)
        return ta.draw_action_noise(16, 2, 4, i, g)

    u, n = draws(0), draws(1)
    assert u.shape == (16, 2, 4) and n.shape == (2, 16, 4)
    assert bool((u >= 0).all() and (u < 1).all()) and float(n.std()) > 0.5
    assert torch.equal(u, draws(0)) and torch.equal(n, draws(1))


# ------------------------------------------------------------------ costs


def _cost_inputs(seed, bsz=8, n_look=2, n=20):
    rng = np.random.RandomState(seed)
    state = (rng.rand(bsz, n_look, n, 3) * 2 - 1).astype(np.float32)
    state_cur = (rng.rand(n, 3) * 2 - 1).astype(np.float32)
    action = _actions(seed + 1, (bsz, n_look)) * 0.3
    mask = np.ones(n, bool)
    mask[-4:] = False
    return state, action, state_cur, mask


@pytest.mark.parametrize("kind", ["rope", "cloth", "granular"])
def test_penalty_matches_jax(kind):
    state, action, state_cur, _ = _cost_inputs(4)
    pj = jc.PENALTIES[kind](_j(state), _j(action), _j(state_cur))
    pt = tc.PENALTIES[kind](_t(state), _t(action), _t(state_cur))
    assert pt.shape == (8, 2) and float(pt.abs().max()) > 1e-3
    _close(pt, pj)


@pytest.mark.parametrize("target_type", ["box", "pcd"])
def test_error_fn_matches_jax(target_type):
    state, _, _, mask = _cost_inputs(5)
    flat = state.reshape(-1, 20, 3)
    task = {"target_type": target_type, "target": [-0.5, 0.5, -0.2, 0.3]}
    target = np.random.RandomState(6).rand(31, 3).astype(np.float32)
    mflat = np.tile(mask[None], (flat.shape[0], 1))
    ej = jc.make_error_fn(task, target_state=target)(_j(flat), _j(mflat))
    et = tc.make_error_fn(task, target_state=target, device="cpu")(
        _t(flat), _t(mflat))
    _close(et, ej)


@pytest.mark.parametrize("kind", ["rope", "granular", "cloth"])
def test_chunked_cost_matches_jax(kind):
    """rewards of a population of 8 in chunks of 3 (the last chunk padded)
    against JAX's chunked rewards, and against the port's unchunked ones:
    equal for the rope and granular penalties; the cloth penalty, which
    normalises per chunk, moves them by what it moves JAX's."""
    state, action, state_cur, mask = _cost_inputs(7)
    target = np.random.RandomState(8).rand(25, 3).astype(np.float32)
    bbox = np.array([[-0.9, 0.9], [-0.9, 0.9]], np.float32)
    task = {"target_type": "pcd"}
    out = {}
    for side, mod, cv in (("jax", jc, _j), ("port", tc, _t)):
        err = mod.make_error_fn(task, target_state=target, **(
            {"device": "cpu"} if side == "port" else {}))
        for n_chunk in (0, 3):
            out[side, n_chunk] = mod.chunked_cost(
                cv(state), cv(action), cv(state_cur), err,
                mod.PENALTIES[kind], cv(bbox), obj_mask=cv(mask),
                n_chunk=n_chunk)
    for n_chunk in (0, 3):
        for k in ("reward_seqs", "error_seqs"):
            _close(out["port", n_chunk][k], out["jax", n_chunk][k])
    moved_t = _np(out["port", 3]["reward_seqs"]) - _np(
        out["port", 0]["reward_seqs"])
    moved_j = _np(out["jax", 3]["reward_seqs"]) - _np(
        out["jax", 0]["reward_seqs"])
    _close(moved_t, moved_j)
    if kind == "cloth":
        assert np.abs(moved_t).max() > 1e-3
    else:
        assert np.abs(moved_t).max() <= 1e-6


# ------------------------------------------------------- batched dynamics


def _task(**over):
    task = {"pusher_points": [[0.0, 0.0, 0.1]], "sim_real_ratio": 10,
            "push_length": 0.2, "adj_thresh": 0.5, "topk": 5,
            "connect_tools_all": False, "max_nR": 200, "n_his": 4,
            "gripper_enable": False, "max_nobj": 24,
            "material_dims": {"rope": 1},
            "action_lower_lim": [-4.5, -2.5, -3.14, 2],
            "action_upper_lim": [0.0, 4.5, 3.14, 4]}
    task.update(over)
    return task


def _graph_args(nobj, n_eef, n_his=4):
    """A graph of nobj objects and n_eef tools, as model.init takes it."""
    state = np.random.RandomState(0).rand(nobj, 3).astype(np.float32)
    full = jnp.tile(jnp.concatenate([_j(state), jnp.zeros((n_eef, 3))])[None],
                    (n_his, 1, 1))
    tools = jnp.zeros(nobj + n_eef, bool).at[nobj:].set(True)
    e = j_slotted(full[-1], 0.5, jnp.ones(nobj + n_eef, bool), tools, topk=5)
    return ((full, jnp.zeros((nobj + n_eef, 2)), e.receivers, e.senders,
             e.valid, jnp.ones((nobj, 1)), jnp.array([0.5])),
            {"action": jnp.zeros((nobj + n_eef, 3))})


def _models(cfg, seed=0):
    """(JAX model, flax params, port model, port params) of one weight set:
    the port's init from a seeded generator, its biases drawn from a numpy
    seed, carried to a flax tree (kernel = weight transposed)."""
    model = DynamicsPredictor(ModelConfig(n_his=cfg.n_his, nf=cfg.nf,
                                          pstep=cfg.pstep), device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    tree = {}
    with torch.no_grad():
        for name in model.cfg.layer_shapes():
            layer = model.get_submodule(name)
            layer.bias.copy_(_t(rng.randn(*layer.bias.shape) * 0.1))
            module, dense = name.split(".")
            tree.setdefault(module, {})[dense] = {
                "kernel": _j(_np(layer.weight).T), "bias": _j(_np(layer.bias))}
    return JModel(cfg), tree, model.eval(), dict(model.state_dict())


def _port_model(tcfg, jparams):
    model = DynamicsPredictor(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          tcfg), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def small():
    """The JAX tests' model (nf 16, pstep 1) on both sides: (jmodel,
    jparams, port model, port params)."""
    return _models(JConfig(n_his=4, nf=16, pstep=1))


def _rollouts(small, task, state, mask, acts, phys, eef_y_mode="min"):
    jmodel, jparams, model, params = small
    j = jf.make_batched_dynamics(jmodel, task, eef_y_mode)(
        jparams, _j(state), _j(mask), _j(acts), _j(phys))
    with torch.no_grad():
        t = tf.make_batched_dynamics(model, task, eef_y_mode)(
            params, _t(state), _t(mask), _t(acts), _t(phys))
    return j, t


def test_rollout_shapes_and_repeat_semantics(small):
    nobj = 30
    rng = np.random.RandomState(0)
    state = rng.rand(nobj, 3).astype(np.float32)
    mask = np.ones(nobj, bool)
    mask[-3:] = False
    acts = np.array([[[-1.0, 0.5, 0.3, 3.0], [-0.5, 0.2, 1.0, 2.0]],
                     [[-2.0, 1.0, -0.5, 0.0], [-1.0, 0.2, 0.4, 4.9]],
                     [[-0.8, 0.6, 2.0, 1.9], [-0.2, 0.4, -1.5, 3.2]]],
                    np.float32)
    j, t = _rollouts(small, _task(), state, mask, acts, np.array([0.5]))
    seqs = _np(t["state_seqs"])
    assert seqs.shape == (3, 2, nobj, 3)
    _close(t["state_seqs"], j["state_seqs"])
    _close(t["action_seqs"], j["action_seqs"], atol=1e-7)
    # a sample with 0 repeats (sample 1's first step) returns its input
    # state; 1.9 truncates to 1 repeat (sample 2's first step)
    np.testing.assert_allclose(seqs[1, 0], state, atol=1e-6)
    assert np.abs(seqs[0, 0] - state).max() > 1e-5
    assert np.abs(seqs[2, 0] - state).max() > 1e-5


@pytest.mark.parametrize("eef_y_mode", ["min", "mean"])
def test_per_sample_states_and_physics_match_jax(small, eef_y_mode):
    rng = np.random.RandomState(9)
    state = rng.rand(5, 30, 3).astype(np.float32)
    mask = rng.rand(5, 30) < 0.8
    acts = _actions(10, (5, 1)) * np.array([0.3, 0.3, 1, 0.3], np.float32)
    phys = rng.rand(5, 1).astype(np.float32)
    j, t = _rollouts(small, _task(), state, mask, acts, phys, eef_y_mode)
    _close(t["state_seqs"], j["state_seqs"])


def test_chunked_population_matches_unchunked(small):
    """n_sample_chunk is a memory layout only: chunks of 2 and 3 (8 samples,
    the last chunk padded) give the unchunked rollout bit for bit on the
    CPU, as JAX's lax.map does."""
    _, _, model, params = small
    rng = np.random.RandomState(1)
    state = _t(rng.rand(30, 3).astype(np.float32))
    mask = torch.ones(30, dtype=torch.bool)
    acts = rng.uniform(-2, 2, (8, 1, 4)).astype(np.float32)
    acts[..., 3] = rng.uniform(2, 4, (8, 1))
    outs = {}
    with torch.no_grad():
        for chunk in (0, 2, 3):
            outs[chunk] = tf.make_batched_dynamics(
                model, _task(n_sample_chunk=chunk))(
                params, state, mask, _t(acts), _t([0.5]))["state_seqs"]
    assert outs[3].shape[0] == 8  # the pad rows sliced off
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[0], outs[3])


def test_model_sees_flex_frame():
    """The model works in the flex frame (the plan frame's z negated): a
    model that moves every object point by +1 along z IN THE FRAME IT IS
    GIVEN moves the plan-frame state by -1 along z a repeat."""

    class FakeModel(torch.nn.Module):
        def forward(self, hist, attrs, recv, send, valid, p_instance,
                    physics, action=None):
            n_obj = p_instance.shape[1]
            return hist[:, -1, :n_obj] + hist.new_tensor([0.0, 0.0, 1.0]), None

    state = np.random.RandomState(3).rand(12, 3).astype(np.float32)
    acts = _t([[[-1.0, 0.5, 0.3, 2.0]]])  # 2 repeats
    out = tf.make_batched_dynamics(FakeModel(), _task(
        action_upper_lim=[0.0, 4.5, 3.14, 2]))(
        {}, _t(state), torch.ones(12, dtype=torch.bool), acts, _t([0.5]))
    _close(out["state_seqs"][0, 0], state + np.array([0, 0, -2.0], np.float32))


@pytest.mark.parametrize("material", ["rope", "granular", "cloth"])
def test_task_config_rollout_matches_jax(material):
    """Each task config's pusher geometry: the rope's 1-point pusher, the
    granular 5-point board, the cloth's gripper with connect_tools_all."""
    task = dict(j_load_config(f"planning/{material}")["task_config"])
    port_task = dict(t_load_config(f"planning/{material}")["task_config"])
    assert port_task == task
    task.update(max_nobj=20, action_upper_lim=list(task["action_upper_lim"][
        :3]) + [float(task["action_lower_lim"][3]) + 1])
    small = _models(JConfig(n_his=int(task["n_his"]), nf=16, pstep=1), 2)
    rng = np.random.RandomState(0)
    state = rng.rand(20, 3).astype(np.float32)
    mask = np.ones(20, bool)
    lo = np.asarray(task["action_lower_lim"], np.float32)
    hi = np.asarray(task["action_upper_lim"], np.float32)
    acts = (rng.rand(6, 1, 4) * (hi - lo) + lo).astype(np.float32)
    j, t = _rollouts(small, task, state, mask, acts, np.array([0.5]))
    assert t["state_seqs"].shape == (6, 1, 20, 3)
    assert bool(torch.isfinite(t["state_seqs"]).all())
    _close(t["state_seqs"], j["state_seqs"])


def _partial_mask(kind, n_sample, nobj, rng):
    """A mask that leaves object rows out of every sample: (nobj,) with
    holes (every third row), (nobj,) with few rows (fewer objects and
    pushers than topk), or (S, nobj) per sample whose union leaves every
    fourth row out."""
    if kind == "holes":
        return np.arange(nobj) % 3 != 2
    if kind == "few":
        return np.isin(np.arange(nobj), [1, 4, 5, 9])
    mask = rng.rand(n_sample, nobj) < 0.7
    mask[:, 3::4] = False
    return mask


@pytest.mark.parametrize("kind", ["holes", "per_sample", "few"])
@pytest.mark.parametrize("material", ["rope", "granular"])
def test_compacted_rollout_matches_jax(material, kind):
    """Masks that leave rows out of the whole population (the rollout runs
    on the rows some sample holds and scatters back): JAX's full-width
    rollout on the rope's 1-point pusher and the granular 5-point board,
    over two look-ahead steps, one sample's first step of 0 repeats (its
    left-out rows keep the input state) and another's second step."""
    task = dict(j_load_config(f"planning/{material}")["task_config"])
    lo = np.asarray(task["action_lower_lim"], np.float32)
    task.update(max_nobj=24, action_upper_lim=list(task["action_upper_lim"][
        :3]) + [float(lo[3]) + 1])
    hi = np.asarray(task["action_upper_lim"], np.float32)
    small = _models(JConfig(n_his=int(task["n_his"]), nf=16, pstep=1), 2)
    rng = np.random.RandomState(5)
    mask = _partial_mask(kind, 5, 24, rng)
    # JAX takes a per-sample mask with per-sample states
    state = rng.rand(*mask.shape[:-1], 24, 3).astype(np.float32)
    acts = (rng.rand(5, 2, 4) * (hi - lo) + lo).astype(np.float32)
    acts[1, 0, 3] = 0.5
    acts[3, 1, 3] = 0.0
    j, t = _rollouts(small, task, state, mask, acts, np.array([0.5]))
    seqs = _np(t["state_seqs"])
    assert seqs.shape == (5, 2, 24, 3)
    _close(t["state_seqs"], j["state_seqs"])
    out = ~mask.reshape(-1, 24).any(0)
    np.testing.assert_array_equal(seqs[1, 0][out],
                                  (state[1] if state.ndim == 3 else state)[out])
    assert not seqs[0, :, out].any() and not seqs[3, :, out].any()


def test_compacted_rollout_gradient_matches_jax(small):
    """The GD path through a rollout with rows left out: the gradient of
    the states' sum in the actions against jax.grad."""
    jmodel, jparams, model, params = small
    task = _task(action_upper_lim=[0.0, 4.5, 3.14, 3])
    rng = np.random.RandomState(6)
    state = (rng.rand(30, 3) * 0.6).astype(np.float32)
    mask = np.arange(30) % 3 != 0
    acts = rng.uniform(-0.2, 0.8, (4, 1, 4)).astype(np.float32)
    acts[..., 3] = [[2.5], [3.0], [2.0], [2.9]]
    jroll = jf.make_batched_dynamics(jmodel, task)
    g_j = jax.jit(jax.grad(lambda a: jnp.sum(jroll(
        jparams, _j(state), _j(mask), a, jnp.array([0.5]))["state_seqs"]
        ** 2)))(_j(acts))
    a = _t(acts).requires_grad_(True)
    out = tf.make_batched_dynamics(model, task)(
        params, _t(state), _t(mask), a, _t([0.5]))
    (out["state_seqs"] ** 2).sum().backward()
    assert float(a.grad.abs().max()) > 1e-3
    _close(a.grad, g_j)


class _WidthModel(torch.nn.Module):
    """Records the node rows of every forward it is given; moves nothing."""

    def __init__(self):
        super().__init__()
        self.widths = []

    def forward(self, hist, attrs, recv, send, valid, p_instance, physics,
                action=None):
        self.widths.append(hist.shape[2])
        return hist[:, -1, :p_instance.shape[1]], None


@pytest.mark.parametrize("material", ["rope", "granular"])
def test_rollout_runs_on_the_rows_the_population_holds(material):
    """The model gets k + P node rows where the mask holds k of nobj rows
    (the union of per-sample masks), and nobj + P under a full mask."""
    task = dict(t_load_config(f"planning/{material}")["task_config"])
    task.update(n_sample_chunk=2, action_upper_lim=list(
        task["action_upper_lim"][:3]) + [2])
    n_pusher = len(task["pusher_points"])
    rng = np.random.RandomState(7)
    state = _t(rng.rand(24, 3).astype(np.float32))
    acts = _t(np.tile(np.array([[[-1.0, 0.5, 0.3, 2.0]]], np.float32),
                      (3, 1, 1)))
    per_sample = rng.rand(3, 24) < 0.6
    per_sample[:, :8] = False
    for mask, k in ((np.arange(24) % 3 != 2, 16),
                    (per_sample, int(per_sample.any(0).sum())),
                    (np.ones(24, bool), 24)):
        fake = _WidthModel()
        tf.make_batched_dynamics(fake, task)(
            {}, state, _t(mask), acts, _t([0.5]))
        assert fake.widths == [k + n_pusher] * 4  # 2 chunks x 2 repeats


# ------------------------------------------------------- rope checkpoint


@pytest.fixture(scope="module")
def rope():
    """The rope checkpoint on both sides (JAX restores it, params_from_jax
    carries it across), the planning task at max_nobj 32, and the logged
    interactions of data/plan_rope."""
    jdyn = j_load_config("dynamics/rope")
    jmodel = JModel(j_model_config(jdyn["model_config"],
                                   jdyn["dataset_config"], 1))
    args, kwargs = _graph_args(30, 1)
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    params_like = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=one),
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args,
                                           **kwargs)["params"]))
    ckpt = os.path.join(_ROOT, "data", "log", "rope", "checkpoints")
    jparams = load_checkpoint(ckpt, "latest", params_like)
    tdyn = t_load_config("dynamics/rope")
    tcfg = model_config_from_yaml(tdyn["model_config"],
                                  tdyn["dataset_config"], 1)
    model = _port_model(tcfg, jparams)
    task = dict(t_load_config("planning/rope")["task_config"], max_nobj=32)
    files = sorted(glob.glob(os.path.join(_PLAN_ROPE, "interaction_*.npz")))
    logs = [np.load(f) for f in files]
    return dict(jmodel=jmodel, jparams=jparams, model=model,
                params=dict(model.state_dict()), task=task, files=files,
                acts=[d["act"] for d in logs],
                inits=[d["state_init"] for d in logs],
                reals=[d["state_real"] for d in logs])


@pytest.mark.parametrize("phys", [0.2, 0.5, 0.8])
def test_rope_masked_replay_and_dynamics_error(rope, phys, tmp_path):
    assert len(rope["files"]) == 15
    jopt = JOptimizer(rope["task"], rope["jmodel"], rope["jparams"], "rope",
                      str(tmp_path))
    topt = TOptimizer(rope["task"], rope["model"], rope["params"], "rope",
                      str(tmp_path), device="cpu")
    b, n = len(rope["acts"]), int(rope["task"]["max_nobj"])
    init = np.zeros((b, n, 3), np.float32)
    mask = np.zeros((b, n), bool)
    for i, s in enumerate(rope["inits"]):
        init[i, :len(s)], mask[i, :len(s)] = s, True
    acts = np.stack(rope["acts"]).astype(np.float32)
    pp = np.full((b, 1), phys, np.float32)
    j = jopt.replay(rope["jparams"], _j(init), _j(mask), _j(acts), _j(pp))
    with torch.no_grad():
        t = topt.replay(rope["params"], _t(init), _t(mask), _t(acts), _t(pp))
    _close(t["state_seqs"], j["state_seqs"])
    assert np.abs(_np(t["state_seqs"]) - init).max() > 1e-3
    args = ([phys], rope["acts"], rope["inits"], rope["reals"])
    ej, et = jopt.dynamics_error(*args), topt.dynamics_error(*args)
    assert 0.01 < et < 10
    assert abs(et - ej) <= _ATOL


def test_rope_mppi_step_matches_jax(rope):
    """One planning step as plan.py composes it (target mode, the recorded
    target pcd, the rope penalty, the task's bbox): 12 samples in chunks of
    5 (the last padded), 2 MPPI iterations from the initial action
    [-1, 0, 0, action_lower_lim[3]], JAX's draws."""
    task = dict(rope["task"], n_sample_chunk=5)
    ratio = float(task["sim_real_ratio"])
    n, n_sample = int(task["max_nobj"]), 12
    s0 = rope["inits"][0]
    state = np.zeros((n, 3), np.float32)
    state[:len(s0)] = s0
    mask = np.zeros(n, bool)
    mask[:len(s0)] = True
    target = np.load(os.path.join(_PLAN_ROPE, "target_pcd.npy")) * ratio
    bbox = np.asarray(task["bbox"], np.float32)
    bbox_plan = np.array([[bbox[0] * ratio, bbox[3] * ratio],
                          [bbox[2] * ratio, bbox[5] * ratio]], np.float32)
    phys = np.array([0.5], np.float32)
    init_act = np.array([[-1.0, 0.0, 0.0, float(task["action_lower_lim"][3])]],
                        np.float32)
    res = {}
    for side, mod, fd, cham, plan_cls, cv in (
            ("jax", jc, jf, j_chamfer, JPlanner, _j),
            ("port", tc, tf, t_chamfer, TPlanner, _t)):
        params = rope["jparams"] if side == "jax" else rope["params"]
        model = rope["jmodel"] if side == "jax" else rope["model"]
        roll = fd.make_batched_dynamics(model, task)
        st, mk, tg = cv(state), cv(mask), cv(target.astype(np.float32))

        def err(flat, mflat, tg=tg, cham=cham):
            return cham(flat, tg[None], x_mask=mflat)

        def core(ss, aa, mod=mod, err=err, st=st, mk=mk, cv=cv):
            return mod.chunked_cost(ss, aa, st, err, mod.PENALTIES["rope"],
                                    cv(bbox_plan), obj_mask=mk,
                                    n_chunk=int(task["n_sample_chunk"]))

        # one jitted evaluator on the JAX side, as plan.py has it
        core = jax.jit(core) if side == "jax" else core

        def evaluate(ss, aa, state_cur=None, core=core):
            return core(ss, aa)

        cfg = {"action_dim": 4,
               "model_rollout_fn": lambda sc, a, roll=roll, params=params,
               st=st, mk=mk, cv=cv: roll(params, st, mk, a, cv(phys)),
               "evaluate_traj_fn": evaluate, "n_sample": n_sample,
               "n_look_ahead": 1, "n_update_iter": 2,
               "reward_weight": float(task["reward_weight"]),
               "action_lower_lim": np.asarray(task["action_lower_lim"],
                                              np.float32),
               "action_upper_lim": np.asarray(task["action_upper_lim"],
                                              np.float32),
               "planner_type": "MPPI",
               "noise_level": float(task["noise_level"]),
               "push_length": float(task["push_length"]), "verbose": True}
        if side == "jax":
            res[side] = plan_cls(cfg).trajectory_optimization(
                st, cv(init_act), key=jax.random.PRNGKey(3))
        else:
            res[side] = plan_cls(dict(cfg, device="cpu",
                                      noise_fn=jax_draws(3))
                                 ).trajectory_optimization(st, cv(init_act))
    j, t = res["jax"], res["port"]
    for it in range(2):
        rj = _np(j["eval_outputs"][it]["reward_seqs"])
        rt = _np(t["eval_outputs"][it]["reward_seqs"])
        assert rt.shape == (n_sample,) and np.isfinite(rt).all()
        _close(rt, rj)
        _close(t["model_outputs"][it]["state_seqs"],
               j["model_outputs"][it]["state_seqs"])
    # the chosen action: JAX's, unless JAX's two best rewards tie within the
    # tolerance, when either of the two is accepted
    rewards = np.concatenate([_np(e["reward_seqs"]) for e in j["eval_outputs"]])
    samples = np.concatenate([_np(m["action_seqs"]) for m in j["model_outputs"]])
    top2 = np.argsort(-rewards, kind="stable")[:2]
    chosen = _np(ja.decode_action(_j(_np(t["act_seq"])[None]), 0.1)[0][0])
    candidates = [top2[0]] + ([top2[1]] if rewards[top2[0]] - rewards[top2[1]]
                              <= _ATOL else [])
    assert any(np.abs(chosen - samples[c]).max() <= _ATOL for c in candidates)
    _close(t["act_seq"], j["act_seq"])
    _close(t["best_eval_output"]["reward_seqs"],
           j["best_eval_output"]["reward_seqs"])


# ------------------------------------------------------------- optimisers


def test_gaussian_process_and_gp_ei_equal_jax():
    x = np.linspace(0, 1, 8)[:, None]
    y = np.sin(3 * x[:, 0])
    gj = jo.GaussianProcess(length_scale=0.5, noise=1e-6).fit(x, y, True)
    gt = to.GaussianProcess(length_scale=0.5, noise=1e-6).fit(x, y, True)
    q = np.linspace(-0.2, 1.2, 17)[:, None]
    for a, b in zip(gt.predict(q), gj.predict(q)):
        np.testing.assert_array_equal(a, b)

    def f(x):
        return float((x[0] - 0.37) ** 2 + 0.1 * np.sin(20 * x[0]))

    for dim in (1, 2):
        rj = jo.gp_minimize_ei(f, [(-0.2, 1.2)] * dim, n_calls=14,
                               n_initial=6, noise_level=1e-4, random_state=0)
        rt = to.gp_minimize_ei(f, [(-0.2, 1.2)] * dim, n_calls=14,
                               n_initial=6, noise_level=1e-4, random_state=0)
        for k in rj:
            np.testing.assert_array_equal(rt[k], rj[k])


def test_cmaes_equals_jax():
    def f(x):
        return float(np.sum((x - np.array([0.3, -0.1, 0.6])) ** 2))

    xj, fj = jo.CMAES([0.5, 0.5, 0.5], sigma=0.2, bounds=(-0.2, 1.2),
                      seed=1).optimize(f, iterations=12)
    xt, ft = to.CMAES([0.5, 0.5, 0.5], sigma=0.2, bounds=(-0.2, 1.2),
                      seed=1).optimize(f, iterations=12)
    np.testing.assert_array_equal(xt, xj)
    assert ft == fj


def test_ppo_recovers_known_param(small, tmp_path):
    """The physics-parameter estimate recovers a parameter that made the
    'real' outcomes (the model's own replay at 0.85), and lowers the replay
    error (tests/test_planning.py:335 on the port)."""
    _, _, model, params = small
    task = _task()
    rng = np.random.RandomState(0)
    state = rng.rand(24, 3).astype(np.float32)
    replay = tf.make_masked_replay(model, task)
    ppm = TOptimizer(task, model, params, "rope", str(tmp_path), device="cpu")
    acts = [np.array([-1.0, 0.5, 0.3, 3.0], np.float32),
            np.array([-2.0, 1.0, -0.5, 3.0], np.float32),
            np.array([-1.5, 2.0, 1.2, 4.0], np.float32)]
    for i, a in enumerate(acts):
        with torch.no_grad():
            out = replay(params, _t(state)[None], torch.ones((1, 24),
                                                            dtype=torch.bool),
                         _t(a)[None], torch.full((1, 1), 0.85))
        real = _np(out["state_seqs"][0])
        ppm.log_interaction(i, a, state, real, real)
    p_est, err, err0 = ppm.optimize(len(acts) - 1, iterations=30)
    assert err < err0
    assert abs(float(p_est[0]) - 0.85) < 0.15
    saved = np.load(tmp_path / "ppo_2.npz")
    np.testing.assert_array_equal(saved["physics_param"], p_est)


def test_ppo_seeds_from_latest_refit(small, tmp_path):
    """The numerically latest ppo_*.npz seeds the estimate (stale or not;
    kept as the JAX package has it); a name that does not parse raises in
    both packages."""
    _, _, model, params = small
    for i, v in [(2, 0.31), (10, 0.87)]:
        np.savez(tmp_path / f"ppo_{i}.npz",
                 physics_param=np.array([v], np.float32))
    ppm = TOptimizer(_task(), model, params, "rope", str(tmp_path),
                     device="cpu")
    np.testing.assert_allclose(ppm.physics_param["rope"], [0.87], atol=1e-6)
    np.savez(tmp_path / "ppo_old.npz", physics_param=np.array([0.1]))
    with pytest.raises(ValueError):
        TOptimizer(_task(), model, params, "rope", str(tmp_path),
                   device="cpu")
    with pytest.raises(ValueError):
        JOptimizer(_task(), JModel(JConfig(n_his=4, nf=16, pstep=1)), {},
                   "rope", str(tmp_path))


def test_ppo_never_regresses_incumbent(tmp_path):
    """An objective least at the incumbent 0.4, off the 7-point warmup grid:
    the estimate stays (tests/test_planning.py:417 on the port)."""
    ppm = object.__new__(TOptimizer)
    ppm.material, ppm.dim = "rope", 1
    ppm.physics_param = {"rope": np.array([0.4], np.float32)}
    ppm.save_dir = str(tmp_path)
    ppm._load_interactions = lambda: ([0] * 3, [0] * 3, [0] * 3)
    ppm.dynamics_error = lambda p, a, i, r: 1.0 + 0.1 * abs(
        float(np.atleast_1d(p)[0]) - 0.4)
    p_est, err, err0 = ppm.optimize(2, iterations=7)
    np.testing.assert_allclose(p_est, [0.4], atol=1e-7)
    assert err == err0 and abs(err0 - 1.0) < 1e-8


def test_demo_estimates_from_logs(rope, tmp_path):
    """run_demo over three logged interactions, with the checkpoint's
    state_dict: the estimate and the errors of the JAX optimiser on the
    same logs (a 4-point warmup grid, then the posterior's minimum)."""
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
        for f in rope["files"][:3]:
            shutil.copy(f, tmp_path / d)
    task = dict(rope["task"])
    est = run_demo(task, str(tmp_path / "port"), rope["params"], iterations=4,
                   device="cpu")
    jest = JOptimizer(task, rope["jmodel"], rope["jparams"], "rope",
                      str(tmp_path / "jax")).optimize(2, iterations=4)
    assert abs(float(est[0]) - 0.5) > 1e-3  # the estimate moved
    _close(est, jest[0])
    saved = [np.load(tmp_path / d / "ppo_2.npz") for d in ("port", "jax")]
    for k in ("error", "error_init"):
        assert abs(float(saved[0][k]) - float(saved[1][k])) <= _ATOL


# --------------------------------------------------------------------- GD


def test_gd_step_matches_jax(small):
    """One Adam step of the GD planner: the gradient of the negated mean
    reward through the batched rollout and the updated actions against
    jax.value_and_grad and optax.adam; then the GD planner on both sides
    picks the same action."""
    jmodel, jparams, model, params = small
    task = _task(action_upper_lim=[0.0, 4.5, 3.14, 3])
    rng = np.random.RandomState(4)
    state = (rng.rand(30, 3) * 0.6).astype(np.float32)
    mask = np.ones(30, bool)
    target = state + np.array([0.1, 0.0, 0.1], np.float32)
    bbox = np.array([[-5.0, 5.0], [-5.0, 5.0]], np.float32)
    lo, hi = np.array([-0.2, -0.2, -3.14, 2], np.float32), np.array(
        [0.8, 0.8, 3.14, 3], np.float32)
    u = rng.rand(6, 1, 4).astype(np.float32)
    acts = _np(_t(u) * (_t(hi) - _t(lo)) + _t(lo))
    lr = 1e-2

    jroll = jf.make_batched_dynamics(jmodel, task)
    troll = tf.make_batched_dynamics(model, task)

    def jeval(ss, aa, state_cur=None):
        return jc.running_cost(ss, aa, _j(state), lambda f, m: j_chamfer(
            f, _j(target)[None], x_mask=m), jc.PENALTIES["rope"], _j(bbox),
            obj_mask=_j(mask))

    def teval(ss, aa, state_cur=None):
        return tc.running_cost(ss, aa, _t(state), lambda f, m: t_chamfer(
            f, _t(target)[None], x_mask=m), tc.PENALTIES["rope"], _t(bbox),
            obj_mask=_t(mask))

    def jloss(a):
        out = jroll(jparams, _j(state), _j(mask), a, jnp.array([0.5]))
        return -jnp.mean(jeval(out["state_seqs"], a)["reward_seqs"])

    loss_j, g_j = jax.jit(jax.value_and_grad(jloss))(_j(acts))
    opt = optax.adam(lr)
    upd, _ = opt.update(g_j, opt.init(_j(acts)))
    new_j = ja.clip_actions(optax.apply_updates(_j(acts), upd), _j(lo), _j(hi))

    a = _t(acts).requires_grad_(True)
    out = troll(params, _t(state), _t(mask), a, _t([0.5]))
    loss_t = -teval(out["state_seqs"], a)["reward_seqs"].mean()
    loss_t.backward()
    _close(loss_t, loss_j)
    assert float(a.grad.abs().max()) > 1e-3
    _close(a.grad, g_j)
    topt = torch.optim.Adam([a], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    topt.step()
    _close(ta.clip_actions(a.detach(), _t(lo), _t(hi)), new_j)

    # the GD planner, one update: the step above, then the best of the
    # updated population (scored by JAX) and its rollout
    out_j = jroll(jparams, _j(state), _j(mask), new_j, jnp.array([0.5]))
    best = int(jnp.argmax(jax.jit(jeval)(out_j["state_seqs"], new_j)[
        "reward_seqs"]))
    rt = TPlanner({"action_dim": 4, "n_sample": 6, "n_look_ahead": 1,
                   "n_update_iter": 1, "reward_weight": 100.0,
                   "action_lower_lim": lo, "action_upper_lim": hi,
                   "planner_type": "GD", "lr": lr, "device": "cpu",
                   "evaluate_traj_fn": teval,
                   "noise_fn": lambda i, n_s, n_l, ad: _t(u),
                   "model_rollout_fn": lambda sc, aa: troll(
                       params, _t(state), _t(mask), aa, _t([0.5]))}
                  ).trajectory_optimization(_t(state), _t(acts[0]))
    _close(rt["act_seq"], new_j[best])
    assert rt["best_model_output"]["state_seqs"].shape == (1, 1, 30, 3)


# ------------------------------------------------------------- entry points


def test_planning_entry_points_raise_without_a_device(small, monkeypatch,
                                                      tmp_path):
    _, _, model, params = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"action_dim": 4, "model_rollout_fn": None,
           "evaluate_traj_fn": None, "n_sample": 4, "n_look_ahead": 1,
           "n_update_iter": 1, "reward_weight": 1.0,
           "action_lower_lim": LOWER, "action_upper_lim": UPPER}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPlanner(cfg)
    assert TPlanner(dict(cfg, device="cpu")).device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOptimizer(_task(), model, params, "rope", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_demo(_task(), str(tmp_path), params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.make_error_fn({"target_type": "box", "target": [0, 1, 0, 1]})
    with pytest.raises(TypeError, match="DeviceMesh"):
        TPlanner(dict(cfg, device="cpu", mesh=object()))
    from torch.distributed.device_mesh import init_device_mesh

    from tests.test_torch_parallel import one_rank_group

    with one_rank_group(tmp_path / "store"):
        m2 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("model",
                                                              "data"))
        with pytest.raises(NotImplementedError, match="data axis first"):
            TPlanner(dict(cfg, device="cpu", mesh=m2))


def test_smoke_plan_path_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's planning phases, rehearsed with the CPU in the card's
    place (its CUDA timers and the profiler replaced by host clocks) at a
    small population (12 samples in chunks of 5, max_nobj 40) on a
    synthetic rope: every gate holds, as card and CPU are then one
    device."""
    import time

    import chip_smoke as cs
    from adaptigraph_torch.tools import profile_frame

    def host_ms(fn, reps, warm=1):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)

    def host_profile(fn, steps):
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
        return {"wall_ms_per_frame": 1e3 * wall / steps,
                "device_busy_ms_per_frame": 0.0, "device_idle_share": 1.0,
                "kernel_launches_per_frame": 0.0, "top_kernels": [],
                "profile": None}

    monkeypatch.setattr(cs, "event_ms", host_ms)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profile_frame, "profiled", host_profile)
    rng = np.random.RandomState(0)
    line = np.stack([rng.randn(400) * 0.05, 0.1 + rng.rand(400) * 0.05,
                     np.linspace(-3, 3, 400)], -1).astype(np.float32)
    bent = line + np.stack([0.5 * np.cos(line[:, 2]), 0 * line[:, 2],
                            0 * line[:, 2]], -1).astype(np.float32)
    out = cs.plan_phases("cpu", bent, line, n_sample=12, max_nobj=40,
                         n_chunk=5)
    assert out["mppi_samples_per_s"] > 0 and out["chunk"] == 5
    assert out["card_vs_cpu_state_max"] == 0.0
    assert not any(out["contact_launches"].values())
    assert set(out["forward_chunk_ms_by_mode"]) == {
        "matmul", "segment", "slotted", "slotmm"}
