"""Port parity: the 2-D data x model mesh (adaptigraph_torch/parallel/mesh.py's
make_mesh_2d, shard_params_model and gather_params_model) and the mesh
entry points on it, across four gloo ranks on the CPU, against JAX's
make_mesh_2d(2, 2) + shard_params_model on four of its eight CPU devices,
against the port's 1-D mesh and against one process.

The ranks are four processes started once for the file by
tests/test_torch_parallel.py's `start` and `finish` (a FileStore, one
torch thread a rank, every join timed). The same four ranks form the
meshes (2, 2), (1, 4) and (4, 1) and the 1-D make_mesh(4). The model is
tests/test_parallel_mesh.py's `_tiny_model_batch` (nf 16, pstep 2, B 8),
its flax weights carried across by params_from_jax. The ranks import
this module to find their target, so it imports JAX only inside its
tests and fixtures.

Tolerances:
- mesh coordinates, the layout, shard_batch and replicate: equal;
- one step on (2, 2) against JAX's step on make_mesh_2d(2, 2) +
  shard_params_model: the loss within 1e-6 of itself, the gathered params
  after Adam within 1e-6;
- three steps on (2, 2) and (1, 4) against the port's make_mesh(4): loss
  and gathered params within 1e-5 (a row slice of a weight may round
  its products otherwise); (4, 1), where every layer is column-parallel
  over one rank, equal; the ranks equal, and a second run equal;
- train() on (2, 2) against one process: losses within rtol 1e-5, params
  within 1e-5, as tests/test_torch_parallel.py holds the 1-D mesh;
- the Planner on (2, 2): act_seq within 1e-5 of the meshless one.
"""

import os

import numpy as np
import pytest
import torch

from adaptigraph_torch.dynamics import train as tt
from adaptigraph_torch.parallel import mesh as pm
from tests.test_torch_parallel import (ACT0, N_SAMPLE, finish,
                                       planner_config, start, write_episodes)

WORLD = 4
SHAPES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
# train() on (2, 2): B 8 split 4 + 4 over the data axis through 2-step
# chunks; B 6, which the data axis divides and the whole mesh does not,
# whole on every rank through the host loop (JAX's rule)
TRAIN_RUNS = (("split", {}, 2), ("whole", {"batch_size": 6}, None))
LOSS_KEYS = ("state", "attrs", "recv", "send", "edge_valid", "p_instance",
             "physics_param", "action", "obj_mask", "state_future",
             "eef_future", "action_future")


def _model(params, nf=16):
    from adaptigraph_torch.dynamics import DynamicsPredictor
    from adaptigraph_torch.dynamics.model import ModelConfig

    model = DynamicsPredictor(ModelConfig(n_his=4, nf=nf, pstep=2),
                              device="cpu")
    if params is not None:
        model.load_state_dict(params)
    return model


def _steps(params, batch, mesh, n=3):
    """n make_train_step steps on `mesh` from `params`, the model laid out
    column-parallel on a 2-D mesh: (losses, gathered params after the
    first step, after the last)."""
    model = _model(params)
    if mesh.ndim == 2:
        pm.shard_params_model(model, mesh)
    opt, _ = tt.make_optimizer(model.parameters(), 1e-3)
    step, _ = tt.make_train_step(model, 3, opt, mesh=mesh)
    local = pm.shard_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                           mesh)
    losses, after = [], []
    for _ in range(n):
        losses.append(float(step(local)))
        whole = (pm.gather_params_model(model, mesh) if mesh.ndim == 2
                 else model.state_dict())
        after.append({k: v.clone() for k, v in whole.items()})
    return losses, after[0], after[-1]


def _cases(rank, inp):
    from torch.distributed.device_mesh import init_device_mesh

    from adaptigraph_torch.planning import Planner

    out = {}
    meshes = {name: pm.make_mesh_2d(*shape, device="cpu")
              for name, shape in SHAPES.items()}
    meshes["1d"] = pm.make_mesh(device="cpu")
    m22 = meshes["2x2"]
    out["mesh"] = {name: (tuple(m.mesh_dim_names), tuple(m.shape),
                          tuple(m.get_coordinate()), m.device_type)
                   for name, m in meshes.items()}

    # shard_batch and replicate on (2, 2)
    local = pm.shard_batch(inp["tree"], m22)
    out["shard"] = {k: np.asarray(v if k != "nested" else v[0])
                    for k, v in local.items()}
    mine = {"t": torch.full((3,), float(rank + 1)),
            "a": np.full(2, rank, np.int32), "o": {"r": rank}}
    out["replicate"] = pm.replicate(mine, m22)

    # the layout: (2, 2) on the tiny model, (1, 4) on an nf-18 model
    st = inp["step"]
    model = pm.shard_params_model(_model(st["params"]), m22)
    out["layout"] = {
        "local": {k: v.clone() for k, v in model.state_dict().items()},
        "column": sorted(n for n, m in model.named_modules()
                         if isinstance(m, pm.ColumnDense)),
        "whole": {k: v.clone() for k, v in
                  pm.gather_params_model(model, m22).items()}}
    wide = pm.shard_params_model(_model(None, nf=18), meshes["1x4"])
    out["layout_nf18"] = sorted(n for n, m in wide.named_modules()
                                if isinstance(m, pm.ColumnDense))

    # steps on every mesh, (2, 2) twice
    out["steps"] = {name: _steps(st["params"], st["batch"], m)
                    for name, m in meshes.items()}
    out["steps_again"] = _steps(st["params"], st["batch"], m22)

    # train() on (2, 2)
    tr = inp["train"]
    runs = {}
    for name, over, k in TRAIN_RUNS:
        base = os.path.join(tr["root"], f"{name}_rank{rank}")
        cfg = tr["cfg"].override({"train_config": dict(out_dir=base,
                                                       **over)})
        params, hist = tt.train(cfg, device="cpu", mesh=m22,
                                steps_per_call=k)
        runs[name] = {"params": params, "history": hist,
                      "files": sorted(os.listdir(os.path.join(base, "rope")))
                      if os.path.isdir(base) else None}
    out["train"] = runs

    # the Planner on (2, 2)
    res = {}
    for kind in ("MPPI", "GD"):
        seen = []
        p = Planner(planner_config(kind, inp["draws"][kind], m22, seen))
        r = p.trajectory_optimization(torch.zeros((1, 3)), ACT0, seed=0)
        res[kind] = {"act_seq": r["act_seq"].numpy(), "seen": seen}
    out["planner"] = res

    # what the port refuses
    flipped = init_device_mesh("cpu", (2, 2), mesh_dim_names=("model",
                                                              "data"))
    cube = init_device_mesh("cpu", (1, 2, 2),
                            mesh_dim_names=("data", "model", "pipe"))
    checks = {
        "shard_flipped": lambda: pm.shard_batch({"x": torch.zeros(4)},
                                                flipped),
        "planner_flipped": lambda: Planner(planner_config(
            "MPPI", inp["draws"]["MPPI"], flipped)),
        "train_flipped": lambda: tt.train(tr["cfg"], mesh=flipped,
                                          device="cpu"),
        "shard_3d": lambda: pm.shard_batch({"x": torch.zeros(4)}, cube),
        "mesh_2x3": lambda: pm.make_mesh_2d(2, 3, device="cpu"),
        "mesh_cuda": lambda: pm.make_mesh_2d(2, 2, device="cuda"),
        "layout_1d": lambda: pm.shard_params_model(_model(None),
                                                   meshes["1d"])}
    refused = {}
    for name, fn in checks.items():
        try:
            fn()
            refused[name] = None
        except Exception as e:  # the test reads the type and message
            refused[name] = (type(e).__name__, str(e))
    out["refused"] = refused
    return out


# ------------------------------------------------------------------ fixtures


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_inputs():
    """tests/test_parallel_mesh.py's tiny model and batch: the port's
    state_dict of its flax params (params_from_jax) and the batch as
    numpy, with JAX's own params and batch."""
    import jax

    from adaptigraph_torch.dynamics.model import ModelConfig, params_from_jax
    from tests.test_parallel_mesh import _tiny_model_batch

    model, params, batch = _tiny_model_batch()
    params = jax.tree.map(np.asarray, params)
    batch = {k: np.asarray(batch[k]) for k in LOSS_KEYS}
    sd = params_from_jax(params, ModelConfig(n_his=4, nf=16, pstep=2))
    return {"params": dict(sd), "batch": batch}, (model, params)


def _jax_refs(jax_model, params, batch, tree):
    """JAX on make_mesh_2d(2, 2): the mesh's devices, shard_batch's and
    shard_params_model's shards on each of its devices, one
    make_train_step step (its loss and params, carried back by
    params_from_jax), and the same step on make_mesh(4)."""
    import jax
    import jax.numpy as jnp
    import optax

    from adaptigraph_tpu.dynamics.train import make_train_step
    from adaptigraph_tpu.parallel.mesh import (make_mesh, make_mesh_2d,
                                               replicate, shard_batch,
                                               shard_params_model)
    from adaptigraph_torch.dynamics.model import ModelConfig, params_from_jax

    mesh = make_mesh_2d(2, 2)
    devices = list(mesh.devices.flat)

    def shards(x):
        return [np.asarray(next(s.data for s in x.addressable_shards
                                if s.device == d)) for d in devices]

    flat = dict(tree, nested=tree["nested"][0])
    sharded = shard_batch(flat, mesh)
    placed = shard_params_model(params, mesh)
    specs = {f"{m}.{d}": (tuple(leaf["kernel"].sharding.spec),
                          tuple(leaf["bias"].sharding.spec))
             for m, layers in placed.items() for d, leaf in layers.items()}
    layout = {f"{m}.{d}": {k: shards(v) for k, v in leaf.items()}
              for m, layers in placed.items() for d, leaf in layers.items()}
    opt = optax.adam(1e-3)
    train_step, _ = make_train_step(jax_model, 3, opt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    after2, _, loss2 = train_step(placed, opt.init(placed),
                                  shard_batch(jbatch, mesh))
    mesh1 = make_mesh(4)
    after1, _, loss1 = train_step(replicate(params, mesh1),
                                  replicate(opt.init(params), mesh1),
                                  shard_batch(jbatch, mesh1))
    cfg = ModelConfig(n_his=4, nf=16, pstep=2)
    carry = lambda p: params_from_jax(jax.tree.map(np.asarray, p), cfg)
    return {"devices": [d.id for d in devices],
            "coords": {d.id: tuple(int(c) for c in np.argwhere(
                mesh.devices == d)[0]) for d in devices},
            "shard": {k: shards(v) for k, v in sharded.items()},
            "specs": specs, "layout": layout,
            "step_2d": (carry(after2), float(loss2)),
            "step_1d": (carry(after1), float(loss1))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the ranks' results, JAX's references and one process's
    train() and Planner: {'inputs', 'ranks', 'jax', 'one'}. The ranks run
    while this process computes the rest."""
    from adaptigraph_torch.planning import Planner

    tmp = tmp_path_factory.mktemp("parallel_2d")
    tree = {"div": np.arange(24, dtype=np.float32).reshape(8, 3),
            "two": np.arange(6, dtype=np.float32).reshape(2, 3),
            "odd": np.arange(5, dtype=np.int32),
            "zero": np.array(3.0, np.float32),
            "nested": [np.arange(8, dtype=np.float32).reshape(4, 2)]}
    step, (jax_model, jax_params) = _jax_inputs()
    (tmp / "data").mkdir()
    rs = np.random.RandomState(0)
    draws = {"MPPI": [rs.rand(N_SAMPLE, 1, 4).astype(np.float32),
                      rs.randn(1, N_SAMPLE, 4).astype(np.float32)],
             "GD": [rs.rand(N_SAMPLE, 1, 4).astype(np.float32)]}
    inputs = {"tree": tree, "step": step, "draws": draws,
              "train": {"cfg": write_episodes(tmp / "data"),
                        "root": str(tmp)}}
    started = start(_cases, inputs, tmp, world=WORLD)
    try:
        refs = _jax_refs(jax_model, jax_params, step["batch"], tree)
        one = {"train": {}, "planner": {}}
        for name, over, k in TRAIN_RUNS:
            out = tmp / f"one_{name}"
            cfg = inputs["train"]["cfg"].override(
                {"train_config": dict(out_dir=str(out), **over)})
            params, hist = tt.train(cfg, device="cpu", steps_per_call=k)
            one["train"][name] = {"params": params, "history": hist,
                                  "files": sorted(os.listdir(out / "rope"))}
        for kind in ("MPPI", "GD"):
            seen = []
            act = Planner(planner_config(kind, draws[kind], seen=seen)
                          ).trajectory_optimization(
                torch.zeros((1, 3)), ACT0, seed=0)["act_seq"]
            one["planner"][kind] = {"act_seq": act.numpy(), "seen": seen}
    finally:
        ranks = finish(started, tmp)
    return {"inputs": inputs, "ranks": ranks, "jax": refs, "one": one}


# -------------------------------------------------------------------- tests


def test_rank_r_sits_at_jax_device_rs_coordinates(world):
    """make_mesh_2d lays the model axis fastest, as JAX's does: rank r of
    each 2-D mesh at (r // n_model, r % n_model), on (2, 2) JAX device
    r's place in make_mesh_2d(2, 2).devices."""
    assert world["jax"]["devices"] == list(range(WORLD))
    for r, out in enumerate(world["ranks"]):
        for name, (n_data, n_model) in SHAPES.items():
            assert out["mesh"][name] == (("data", "model"), (n_data, n_model),
                                         (r // n_model, r % n_model), "cpu")
        assert out["mesh"]["2x2"][2] == world["jax"]["coords"][r]
        assert out["mesh"]["1d"] == (("data",), (WORLD,), (r,), "cpu")


def test_shard_batch_on_2x2_equals_jax_shards(world):
    """Rank r's leaves are JAX's shards on device r: 4 rows of the 8 by
    its data coordinate; the leading dim of 2, which divides `data` but
    not the mesh, the odd one and the 0-d one whole."""
    tree = world["inputs"]["tree"]
    for r, out in enumerate(world["ranks"]):
        for k, want in world["jax"]["shard"].items():
            np.testing.assert_array_equal(out["shard"][k], want[r], err_msg=k)
        np.testing.assert_array_equal(out["shard"]["div"],
                                      tree["div"][4 * (r // 2):][:4])
        np.testing.assert_array_equal(out["shard"]["two"], tree["two"])


def test_replicate_on_2x2_gives_every_rank_rank_0s_leaves(world):
    for out in world["ranks"]:
        rep = out["replicate"]
        assert torch.equal(rep["t"], torch.ones(3))
        np.testing.assert_array_equal(rep["a"], np.zeros(2, np.int32))
        assert rep["a"].dtype == np.int32 and rep["o"] == {"r": 0}


def test_layout_equals_jax_leaf_for_leaf(world):
    """Every layer whose out width the model axis divides is
    column-parallel, as JAX's kernel is P(None, 'model') and its bias
    P('model'), and holds its rows of JAX's shard on the same device;
    the head's 16 -> 3 layer stays whole, as JAX replicates it;
    gather_params_model gives the whole weights back."""
    jx = world["jax"]
    params = world["inputs"]["step"]["params"]
    column = sorted(k for k, (kspec, bspec) in jx["specs"].items()
                    if kspec == (None, "model") and bspec == ("model",))
    whole = sorted(k for k, specs in jx["specs"].items() if specs == ((), ()))
    assert len(column) == 10 and whole == ["non_rigid_predictor.Dense_2"]
    for r, out in enumerate(world["ranks"]):
        lay = out["layout"]
        assert lay["column"] == column
        for name, leaves in jx["layout"].items():
            np.testing.assert_array_equal(lay["local"][f"{name}.weight"],
                                          leaves["kernel"][r].T, err_msg=name)
            np.testing.assert_array_equal(lay["local"][f"{name}.bias"],
                                          leaves["bias"][r], err_msg=name)
        assert lay["whole"].keys() == params.keys()
        for k, v in params.items():
            assert torch.equal(lay["whole"][k], v), k


def test_nf18_on_1x4_replicates_every_layer(world):
    """At nf 18 no out width (18, 3) divides a model axis of 4."""
    for out in world["ranks"]:
        assert out["layout_nf18"] == []


def test_one_step_on_2x2_equals_jax(world):
    """One make_train_step step on the column-parallel model over (2, 2)
    against JAX's on make_mesh_2d(2, 2) + shard_params_model: the loss
    within 1e-6 of itself, the gathered params after Adam within 1e-6.
    JAX's own 2-D step lies within 1e-7 of its 1-D step on
    make_mesh(4)."""
    want, loss = world["jax"]["step_2d"]
    want_1d, loss_1d = world["jax"]["step_1d"]
    assert abs(loss - loss_1d) <= 1e-6 * abs(loss_1d)
    for k, v in want.items():
        np.testing.assert_allclose(v, want_1d[k], atol=1e-7, err_msg=k)
    start_params = world["inputs"]["step"]["params"]
    for out in world["ranks"]:
        losses, first, _ = out["steps"]["2x2"]
        assert abs(losses[0] - loss) <= 1e-6 * abs(loss)
        for k, v in want.items():
            np.testing.assert_allclose(first[k].numpy(), v, atol=1e-6,
                                       err_msg=k)
    moved = max(float((first[k] - start_params[k]).abs().max())
                for k in want)
    assert moved > 1e-4  # Adam really stepped


@pytest.mark.parametrize("name", list(SHAPES))
def test_three_steps_equal_the_1d_mesh(world, name):
    """Three steps on a 2-D mesh against the port's make_mesh(4) on the
    same params and batch: losses and gathered params within 1e-5; on
    (4, 1), column-parallel over one rank, equal bit for bit. Every rank
    holds the same gathered params and losses."""
    ranks = world["ranks"]
    want_losses, _, want = ranks[0]["steps"]["1d"]
    losses, _, got = ranks[0]["steps"][name]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
        if name == "4x1":
            assert torch.equal(got[k], v), k
    if name == "4x1":
        assert losses == want_losses
    for out in ranks[1:]:
        assert out["steps"][name][0] == losses
        for k, v in got.items():
            assert torch.equal(out["steps"][name][2][k], v), k


def test_a_second_run_repeats_bit_for_bit(world):
    """Every reduction is an all_gather summed in rank order: (2, 2) run
    again gives the same bits."""
    for out in world["ranks"]:
        losses, first, last = out["steps"]["2x2"]
        again = out["steps_again"]
        assert again[0] == losses
        for k in last:
            assert torch.equal(again[1][k], first[k]), k
            assert torch.equal(again[2][k], last[k]), k


@pytest.mark.parametrize("name", [n for n, _, _ in TRAIN_RUNS])
def test_train_on_2x2_equals_one_process(world, name):
    """train() with make_mesh_2d(2, 2) against one process: B 8 split over
    the data axis through chunks, B 6 whole on every rank (the whole
    mesh does not divide it) through the host loop. Params replicate,
    the ranks are equal, and only rank 0 wrote files."""
    one = world["one"]["train"][name]
    ranks = [out["train"][name] for out in world["ranks"]]
    for phase in ("train", "valid"):
        np.testing.assert_allclose(ranks[0]["history"][phase],
                                   one["history"][phase], rtol=1e-5)
    for k, v in one["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
        if name == "whole":  # nothing averaged: the same arithmetic
            assert torch.equal(ranks[0]["params"][k], v), k
    for r in ranks[1:]:
        assert r["history"] == ranks[0]["history"] and r["files"] is None
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k
    assert ranks[0]["files"] == one["files"]
    assert "train_state.json" in one["files"]


@pytest.mark.parametrize("kind", ["MPPI", "GD"])
def test_planner_on_2x2_splits_the_population_over_data(world, kind):
    """Each rank rolled out its data row's 128 of the 256 samples; act_seq
    within 1e-5 of the meshless one; the ranks equal."""
    one = world["one"]["planner"][kind]
    ranks = [out["planner"][kind] for out in world["ranks"]]
    np.testing.assert_allclose(ranks[0]["act_seq"], one["act_seq"],
                               atol=1e-5)
    iters = 2 if kind == "MPPI" else 3 + 1
    for r in ranks:
        np.testing.assert_array_equal(r["act_seq"], ranks[0]["act_seq"])
        assert r["seen"] == [N_SAMPLE // 2] * iters + [1]
    assert one["seen"] == [N_SAMPLE] * iters + [1]


def test_other_meshes_raise(world):
    """A 2-D mesh whose first dim is not `data`, or of three dims, raises
    NotImplementedError naming the two layouts; make_mesh_2d raises
    ValueError for a mesh that is not the world and RuntimeError where
    gloo cannot carry CUDA tensors; the layout needs a `model` axis."""
    for out in world["ranks"]:
        ref = out["refused"]
        for name in ("shard_flipped", "planner_flipped", "train_flipped",
                     "shard_3d"):
            kind, msg = ref[name]
            assert kind == "NotImplementedError", (name, ref[name])
            assert "make_mesh_2d" in msg and "data axis first" in msg
        assert ref["mesh_2x3"][0] == "ValueError", ref["mesh_2x3"]
        assert "spans the whole world" in ref["mesh_2x3"][1]
        assert ref["mesh_cuda"][0] == "RuntimeError"
        assert "does not carry cuda" in ref["mesh_cuda"][1]
        assert ref["layout_1d"][0] == "ValueError"
        assert "'model' axis" in ref["layout_1d"][1]
