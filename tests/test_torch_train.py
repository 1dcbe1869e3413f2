"""Port parity: the training slice (the graph preparation of
dynamics/dataset.py, the device-resident gather, the unrolled loss and its
gradient, Adam, the K-step chunk and train()) against the JAX package on
the CPU.

Four compact rope episodes (data/compact/rope/000000-000003) are copied
into a temporary directory and preprocessed there by JAX's preprocess;
nothing is written under data/. JAX's random draws are replayed into the
port through `draws` (the same key splits as JAX's _prepare_one).
Tolerances, with the maxima measured on the CPU beside them:
- the prepared batch: indices, masks, edges and attrs exactly; with
  augment off every float exactly; with augment on the rotated floats
  within 1e-6 (4.8e-7: XLA's dot rounds some rows otherwise than the
  port's written-out product, which the card and the CPU round alike);
- the gather: bit for bit;
- the unrolled loss within 1e-6 relative (0) and every gradient leaf
  within 1e-5 of its largest entry (8.3e-7 at full width), through
  params_to_jax;
- Adam against optax.adam on the same gradients: 1e-6 over 5 steps.
train() runs at a narrow width (nf 16, pstep 2, max_nobj 32, B 8).
"""

import io
import json
import os
import shutil
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptigraph_tpu.dynamics import preprocess as jpre
from adaptigraph_tpu.dynamics import train as jt
from adaptigraph_tpu.dynamics.dataset import DynDataset as JDataset
from adaptigraph_tpu.dynamics.dataset import make_prepare_fn as j_prepare_fn
from adaptigraph_tpu.dynamics.model import DynamicsPredictor as JModel
from adaptigraph_tpu.dynamics.model import (
    model_config_from_yaml as j_model_config)
from adaptigraph_tpu.utils import load_config as j_load_config
from adaptigraph_torch.dynamics import train as tt
from adaptigraph_torch.dynamics.dataset import DynDataset as TDataset
from adaptigraph_torch.dynamics.dataset import draw_prepare
from adaptigraph_torch.dynamics.dataset import make_prepare_fn as t_prepare_fn
from adaptigraph_torch.dynamics.model import params_from_jax, params_to_jax
from adaptigraph_torch.utils import load_config as t_load_config

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EPISODES = ("000000", "000001", "000002", "000003")
_GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX config, port config, tmp dir) over four restored and
    preprocessed compact rope episodes."""
    tmp = tmp_path_factory.mktemp("train")
    for name in _EPISODES:
        shutil.copytree(os.path.join(_ROOT, "data", "compact", "rope", name),
                        tmp / "sim_data" / "rope" / name)
    over = {"dataset_config": {"data_dir": str(tmp / "sim_data"),
                               "prep_data_dir": str(tmp / "preprocess")}}
    jcfg = j_load_config("dynamics/rope").override(over)
    tcfg = t_load_config("dynamics/rope").override(over)
    jpre.preprocess(jcfg)
    return jcfg, tcfg, tmp


def _tiny(cfg, out_dir, **train_over):
    """The config at a narrow width for train(): nf 16, pstep 2, max_nobj
    32, max_nR 200, B 8, 2 epochs of 4 train and 2 valid steps."""
    ds = dict(cfg["dataset_config"]["datasets"][0], max_nobj=32, max_nR=200)
    return cfg.override({
        "dataset_config": {"datasets": [ds]},
        "model_config": {"nf_particle": 16, "nf_relation": 16,
                         "nf_effect": 16, "pstep": 2},
        "train_config": dict({"out_dir": str(out_dir), "batch_size": 8,
                              "n_epochs": 2, "log_interval": 50,
                              "n_iters_per_epoch": {"train": 4, "valid": 2}},
                             **train_over)})


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_draws(key, raw, d):
    """The draws of JAX's _prepare_one for each sample of `raw` under
    `key` (make_prepare_fn splits it into one key a sample, and each into
    six), in the port's form; only what the port draws is kept."""
    keys = jax.random.split(key, raw["obj"].shape[0])
    n = d.max_nobj + raw["eef"].shape[2]
    out = {k: [] for k in ("fps_ranks", "fps_r", "adj_r", "state_noise",
                           "theta", "phys_noise")}
    for key_i, nv in zip(keys, raw["nobj_raw"]):
        k_fps, k_rad, k_adj, k_noise, k_rot, k_phys = jax.random.split(key_i, 6)
        k1, k2 = jax.random.split(k_fps)
        nv = int(nv)
        out["fps_ranks"].append([
            int(jax.random.randint(k1, (), 0, jnp.int32(max(nv, 1)))),
            int(jax.random.randint(k2, (), 0,
                                   jnp.int32(max(min(nv, d.max_nobj), 1))))])
        out["fps_r"].append(jax.random.uniform(
            k_rad, (), minval=d.fps_radius_range[0],
            maxval=d.fps_radius_range[1]))
        out["adj_r"].append(jax.random.uniform(
            k_adj, (), minval=d.adj_radius_range[0],
            maxval=d.adj_radius_range[1]))
        out["state_noise"].append(jax.random.uniform(
            k_noise, (d.n_his, n, 3), minval=-d.state_noise,
            maxval=d.state_noise))
        out["theta"].append(jax.random.uniform(k_rot, (), minval=-jnp.pi,
                                               maxval=jnp.pi))
        out["phys_noise"].append(jax.random.uniform(
            k_phys, raw["physics"].shape[1:], minval=-d.phys_noise,
            maxval=d.phys_noise))
    draws = {k: _t(v) for k, v in out.items()}
    if not d.augment:
        del draws["state_noise"], draws["theta"]
    if d.phys_noise == 0:
        del draws["phys_noise"]
    return draws


def _datasets(cfg, phase, augment=None, cls=TDataset):
    d = cls(cfg["dataset_config"], cfg["material_config"], phase)
    if augment is not None:
        d.augment = augment
    return d


@pytest.mark.parametrize("slotted", [False, True], ids=["rowmajor", "slots"])
@pytest.mark.parametrize("augment", [True, False], ids=["augment", "plain"])
def test_prepare_equals_jax(world, augment, slotted):
    jcfg, tcfg, _ = world
    jd = _datasets(jcfg, "train", augment, JDataset)
    td = _datasets(tcfg, "train", augment)
    idx = np.random.RandomState(3).randint(0, len(jd), 8)
    raw = jd.raw_batch(idx)
    key = jax.random.PRNGKey(7)
    jg = jax.tree.map(np.asarray, j_prepare_fn(jd, slotted=slotted)(raw, key))
    tg = t_prepare_fn(td, slotted=slotted)(
        {k: _t(v) for k, v in td.raw_batch(idx).items()},
        _jax_draws(key, raw, jd))
    assert sorted(jg) == sorted(tg)
    assert 8 < int(jg["obj_mask"].sum()) and int(jg["edge_valid"].sum()) > 0
    for k, j in jg.items():
        t = tg[k].numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, k
        if j.dtype.kind != "f" or not augment or k in (
                "attrs", "p_instance", "physics_param"):
            assert np.array_equal(j, t), k
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6, err_msg=k)


def test_draw_prepare_draws_what_is_used(world):
    _, tcfg, _ = world
    td = _datasets(tcfg, "train")
    raw = {k: _t(v) for k, v in td.raw_batch(np.arange(6)).items()}
    gen = torch.Generator().manual_seed(0)
    d = draw_prepare(gen, raw, td)
    assert sorted(d) == ["adj_r", "fps_r", "fps_ranks", "state_noise",
                         "theta"]  # the rope's phys_noise is 0
    assert d["state_noise"].shape == (6, td.n_his, td.max_nobj + td.n_eef, 3)
    assert d["state_noise"].abs().max() <= td.state_noise
    assert d["theta"].abs().max() <= np.pi
    lo, hi = td.fps_radius_range
    assert ((d["fps_r"] >= lo) & (d["fps_r"] <= hi)).all()
    assert (d["fps_ranks"][:, 0] < raw["nobj_raw"]).all()
    assert (d["fps_ranks"][:, 1] < td.max_nobj).all()
    valid = _datasets(tcfg, "valid")
    assert sorted(draw_prepare(gen, raw, valid)) == ["adj_r", "fps_r",
                                                     "fps_ranks"]
    again = draw_prepare(torch.Generator().manual_seed(0), raw, td)
    assert all(torch.equal(d[k], again[k]) for k in d)


def test_device_dataset_gather_equals_raw_batch(world):
    jcfg, tcfg, _ = world
    datasets = {p: _datasets(tcfg, p) for p in ("train", "valid")}
    common, pairs = tt.device_dataset(datasets, device="cpu")
    assert common["obj"].shape[2] == 2898  # episodes of 2,898 and 2,835
    for phase, d in datasets.items():
        idx = np.arange(len(d))[::5]
        raw = d.raw_batch(idx)
        got = tt._gather_raw(common, pairs[phase], torch.as_tensor(idx))
        jraw = _datasets(jcfg, phase, cls=JDataset).raw_batch(idx)
        assert sorted(got) == sorted(raw)
        for k, v in raw.items():
            g = got[k].numpy()
            assert g.dtype == v.dtype and np.array_equal(g, v), k
            assert np.array_equal(jraw[k], v), k
    assert tt.device_dataset(datasets, max_bytes=1e6,
                             device="cpu") == (None, None)


def _rope_checkpoint(tcfg, dataset):
    """The rope checkpoint, restored by JAX (its target's shapes from the
    port's model through params_to_jax) and carried across."""
    model, sd = tt.init_model(tcfg, dataset, device="cpu")
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                                       sharding=one),
                        params_to_jax(sd, model.cfg))
    ckpt = os.path.join(_ROOT, "data", "log", "rope", "checkpoints")
    jparams = jax.tree.map(np.asarray, jt.load_checkpoint(ckpt, "latest", like))
    return model, params_from_jax(jparams, model.cfg)


@pytest.mark.parametrize("width", ["rope_checkpoint", "narrow"])
def test_unrolled_loss_and_grads_equal_jax(world, width):
    """value_and_grad of the unrolled loss: the rope checkpoint at full
    width (nf 150, pstep 3) on 2 graphs, a seeded narrow model (nf 16,
    pstep 2) on 4."""
    jcfg, tcfg, _ = world
    if width == "narrow":
        tcfg = _tiny(tcfg, "unused")
        jcfg = _tiny(jcfg, "unused")
    jd = _datasets(jcfg, "train", cls=JDataset)
    b = 2 if width == "rope_checkpoint" else 4
    g = j_prepare_fn(jd)(jd.raw_batch(np.arange(b) * 40),
                         jax.random.PRNGKey(1))
    if width == "rope_checkpoint":
        model, sd = _rope_checkpoint(tcfg, jd)
    else:
        model, sd = tt.init_model(tcfg, jd, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    jmodel = JModel(j_model_config(jcfg["model_config"],
                                   jcfg["dataset_config"], jd.phys_dim))
    jl, jgrad = jax.jit(jax.value_and_grad(jt.make_unrolled_loss(jmodel, 3)))(
        params_to_jax(sd, model.cfg), g)
    tl, tgrad = tt.loss_and_grads(tt.make_unrolled_loss(model, 3), sd,
                                  {k: _t(v) for k, v in g.items()})
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    ours = params_to_jax(tgrad, model.cfg)
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(jgrad),
                            jax.tree.leaves(ours)):
        j = np.asarray(j)
        assert np.abs(j).max() > 0, path
        assert np.abs(t - j).max() <= _GRAD_RTOL * np.abs(j).max(), path


def test_params_to_jax_inverts_params_from_jax(world):
    _, tcfg, _ = world
    model, sd = tt.init_model(tcfg, _datasets(tcfg, "valid"), device="cpu")
    tree = params_to_jax(sd, model.cfg)
    assert tree["relation_propagator"]["Dense_0"]["kernel"].shape == (450, 150)
    back = params_from_jax(tree, model.cfg)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(ValueError):
        params_to_jax({k: v for k, v in sd.items() if "bias" not in k},
                      model.cfg)


@pytest.mark.parametrize("schedule", [None, "cosine"])
def test_adam_tracks_optax(schedule):
    """5 updates from the same gradients, near-zero entries among them:
    the port's Adam (and LambdaLR cosine) against optax.adam."""
    rng = np.random.RandomState(0)
    shapes = {"w": (16, 8), "b": (8,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for _ in range(5):
        g = {k: (rng.randn(*s) * 10.0 ** rng.randint(-8, 1, s)).astype(
            np.float32) for k, s in shapes.items()}
        grads.append(g)
    lr = 1e-3
    sched = (optax.cosine_decay_schedule(lr, 5, alpha=0.05)
             if schedule == "cosine" else lr)
    opt = optax.adam(sched)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy()))
          for k, v in p0.items()}
    topt, tsched = tt.make_optimizer(list(tp.values()), lr, schedule, 5)
    assert (tsched is None) == (schedule is None)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        topt.step()
        if tsched is not None:
            tsched.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    moved = max(float(np.abs(np.asarray(jp[k]) - p0[k]).max()) for k in p0)
    assert moved > 1e-3


def test_cosine_decay_is_optax_schedule():
    s = optax.cosine_decay_schedule(1e-3, 40, alpha=0.05)
    for c in (0, 1, 17, 39, 40, 55):
        assert abs(1e-3 * tt.cosine_decay(c, 40) - float(s(c))) <= 1e-9


def test_chunk_equals_host_loop_steps(world):
    """K steps through the device-resident chunk and through the host
    loop (raw_batch, then the same prepare), from the same params,
    optimizer state, indices and generator state: equal params."""
    _, tcfg, _ = world
    cfg = _tiny(tcfg, "unused")
    d = _datasets(cfg, "train")
    idxs = np.random.RandomState(0).randint(0, len(d), (3, 8))
    runs = []
    for path in ("chunk", "host"):
        model, _ = tt.init_model(cfg, d, device="cpu")
        opt, sched = tt.make_optimizer(model.parameters(), 1e-3, "cosine", 10)
        gen = torch.Generator().manual_seed(5)
        if path == "chunk":
            common, pairs = tt.device_dataset({"train": d}, device="cpu")
            chunk, _ = tt.make_train_chunk(model, 3, opt, d, common,
                                           pairs["train"], gen, sched)
            losses = chunk(idxs)
        else:
            step, _ = tt.make_train_step(model, 3, opt, sched)
            prep = t_prepare_fn(d)
            losses = []
            for row in idxs:
                raw = {k: _t(v) for k, v in d.raw_batch(row).items()}
                losses.append(step(prep(raw, draw_prepare(gen, raw, d))))
            losses = torch.stack(losses)
        runs.append((losses, model.state_dict()))
    (la, pa), (lb, pb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def _spy_indices(monkeypatch, cls, log):
    orig = cls.raw_batch

    def raw_batch(self, idxs):
        log.append((self.phase, np.asarray(idxs).tolist()))
        return orig(self, idxs)

    monkeypatch.setattr(cls, "raw_batch", raw_batch)


def test_train_host_loop_takes_jax_batches(world, tmp_path, monkeypatch):
    """steps_per_call=None: the per-step host loop draws its batch indices
    as JAX's train() does (dynamics/train.py:300,389): one
    np.random.RandomState(random_seed), B at a time, epoch by epoch and
    phase by phase; and it trains."""
    _, tcfg, _ = world
    log = []
    _spy_indices(monkeypatch, TDataset, log)
    cfg = _tiny(tcfg, tmp_path)
    _, hist = tt.train(cfg, steps_per_call=None, device="cpu")
    rng = np.random.RandomState(42)
    lens = {p: len(_datasets(cfg, p)) for p in ("train", "valid")}
    want = [(p, rng.randint(0, lens[p], size=8).tolist())
            for _ in range(2) for p, n in (("train", 4), ("valid", 2))
            for _ in range(n)]
    assert log == want
    assert len(hist["train"]) == 2 and np.isfinite(hist["train"]).all()


def test_train_chunks(world, tmp_path, monkeypatch):
    """The chunk path: the (K, B) index tables of JAX's chunk loop, the
    iterations rounded up to whole chunks with one note, the files
    written, 'latest' read back equal, 'best' falling back to it."""
    _, tcfg, _ = world
    tables = []
    make = tt.make_train_chunk

    def spying(*a, **kw):
        tr, ev = make(*a, **kw)
        phase = a[3].phase

        def wrap(fn):
            def run(idxs):
                tables.append((phase, np.asarray(idxs).tolist()))
                return fn(idxs)
            return run
        return wrap(tr), wrap(ev)

    monkeypatch.setattr(tt, "make_train_chunk", spying)
    cfg = _tiny(tcfg, tmp_path, n_iters_per_epoch={"train": 3, "valid": 2})
    out = io.StringIO()
    with redirect_stdout(out):
        params, hist = tt.train(cfg, steps_per_call=2, device="cpu")
    text = out.getvalue()
    assert text.count("note: train iters/epoch rounded 3 -> 4") == 1
    assert "note: valid" not in text
    rng = np.random.RandomState(42)
    lens = {p: len(_datasets(cfg, p)) for p in ("train", "valid")}
    want = [(p, rng.randint(0, lens[p], size=(2, 8)).tolist())
            for _ in range(2) for p, n in (("train", 2), ("valid", 1))
            for _ in range(n)]
    assert tables == want
    assert len(hist["train"]) == len(hist["valid"]) == 2
    assert np.isfinite(hist["train"]).all()
    run = tmp_path / "rope"
    for f in ("loss_train.txt", "loss_valid.txt", "loss.png",
              "train_state.json", "checkpoints/latest.pt",
              "checkpoints/latest_optim.pt"):
        assert (run / f).exists(), f
    assert json.loads((run / "train_state.json").read_text()) == {"epoch": 2}
    np.testing.assert_allclose(np.loadtxt(run / "loss_train.txt"),
                               hist["train"], rtol=1e-7)
    latest = tt.load_checkpoint(run / "checkpoints", "latest", "cpu")
    assert all(torch.equal(latest[k], params[k]) for k in params)
    if not (run / "checkpoints" / "best.pt").exists():
        best = tt.load_checkpoint(run / "checkpoints", "best", "cpu")
        assert all(torch.equal(best[k], latest[k]) for k in latest)
    (run / "checkpoints" / "best.pt").unlink(missing_ok=True)
    best = tt.load_checkpoint(run / "checkpoints", "best", "cpu")
    assert all(torch.equal(best[k], latest[k]) for k in latest)


def test_train_resume_continues_epochs(world, tmp_path):
    """A 2-epoch run, then resume=True to 3 epochs: one more epoch from
    the latest params and Adam state, the history cut to the first two."""
    _, tcfg, _ = world
    cfg = _tiny(tcfg, tmp_path)
    _, h2 = tt.train(cfg, epochs=2, steps_per_call=2, device="cpu")
    out = io.StringIO()
    with redirect_stdout(out):
        _, h3 = tt.train(cfg, epochs=3, resume=True, steps_per_call=2,
                         device="cpu")
    assert "resumed from epoch 2" in out.getvalue()
    assert out.getvalue().count("train loss") == 1
    assert len(h3["train"]) == 3 and h3["train"][:2] == pytest.approx(
        h2["train"], rel=1e-7)
    opt = torch.load(tmp_path / "rope" / "checkpoints" / "latest_optim.pt",
                     weights_only=True)
    assert opt["lr_schedule"] is None
    assert {int(s["step"]) for s in opt["optimizer"]["state"].values()} == {12}


def test_train_cosine_resume_takes_a_fresh_optimizer(world, tmp_path):
    """Resuming a plain-Adam checkpoint under lr_schedule 'cosine' keeps
    the params and starts a fresh Adam, as JAX does where its optimizer
    state does not restore."""
    _, tcfg, _ = world
    cfg = _tiny(tcfg, tmp_path)
    tt.train(cfg, epochs=1, steps_per_call=2, device="cpu")
    cos = cfg.override({"train_config": {"lr_schedule": "cosine"}})
    out = io.StringIO()
    with redirect_stdout(out):
        _, h = tt.train(cos, epochs=2, resume=True, steps_per_call=2,
                        device="cpu")
    assert "keeping fresh optimizer state" in out.getvalue()
    assert len(h["train"]) == 2 and np.isfinite(h["train"]).all()
    opt = torch.load(tmp_path / "rope" / "checkpoints" / "latest_optim.pt",
                     weights_only=True)
    assert opt["lr_schedule"] == "cosine"
    assert opt["scheduler"]["last_epoch"] == 4  # the fresh Adam's 4 steps
    assert {int(s["step"]) for s in opt["optimizer"]["state"].values()} == {4}


def test_train_wall_budget_and_missing_matplotlib(world, tmp_path,
                                                  monkeypatch):
    """wall_budget_s stops before an epoch that would not fit; without
    matplotlib one line says loss.png was skipped and training goes on."""
    _, tcfg, _ = world
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = io.StringIO()
    with redirect_stdout(out):
        _, h = tt.train(_tiny(tcfg, tmp_path), epochs=3, wall_budget_s=1e-3,
                        steps_per_call=2, device="cpu")
    text = out.getvalue()
    assert len(h["train"]) == 1
    assert "wall budget" in text and "stopping before epoch 1" in text
    assert text.count("matplotlib is not installed: loss.png skipped") == 1
    assert not (tmp_path / "rope" / "loss.png").exists()
    assert (tmp_path / "rope" / "loss_train.txt").exists()


def test_train_refuses_a_mesh_and_needs_a_device(world, tmp_path,
                                                 monkeypatch):
    """train() takes a 1-D ('data',) or 2-D ('data', 'model') DeviceMesh
    only: anything else than a DeviceMesh raises TypeError, a mesh whose
    first dim is not 'data' NotImplementedError; without a device and
    without CUDA it raises."""
    from torch.distributed.device_mesh import init_device_mesh

    from tests.test_torch_parallel import one_rank_group

    _, tcfg, _ = world
    with pytest.raises(TypeError, match="DeviceMesh"):
        tt.train(_tiny(tcfg, tmp_path), mesh=object(), device="cpu")
    with one_rank_group(tmp_path / "store"):
        m2 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("model",
                                                              "data"))
        with pytest.raises(NotImplementedError, match="data axis first"):
            tt.train(_tiny(tcfg, tmp_path), mesh=m2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.train(_tiny(tcfg, tmp_path))


def test_smoke_train_path_runs_on_the_cpu(world, tmp_path, monkeypatch):
    """chip_smoke.py's train phases, rehearsed with the CPU in the card's
    place at the narrow width, B 8 and 2 steps a chunk over the four
    episodes: every gate holds (card and CPU are then one device), and no
    contact kernel is counted."""
    import time

    import chip_smoke as cs
    from adaptigraph_torch.tools import profile_frame

    def host_split(parts, reps):
        out, x = [], None
        for fn in parts:
            t0 = time.perf_counter()
            x = fn(x)
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    def host_profile(fn, frames):
        t0 = time.perf_counter()
        fn()
        return {"wall_ms_per_frame": 1e3 * (time.perf_counter() - t0) / frames,
                "device_busy_ms_per_frame": 0.0, "device_idle_share": 1.0,
                "kernel_launches_per_frame": 0.0, "top_kernels": [],
                "profile": None}

    monkeypatch.setattr(cs, "split_ms", host_split)
    monkeypatch.setattr(profile_frame, "profiled", host_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    _, tcfg, _ = world
    lines = []
    monkeypatch.setattr(cs, "emit",
                        lambda r: lines.append(json.loads(json.dumps(r))))
    monkeypatch.setattr(cs, "TRAIN_K", 2)
    monkeypatch.setattr(cs, "TRAIN_TIME_CHUNKS", 1)
    out = cs.train_phases("cpu", _tiny(tcfg, "unused"), str(tmp_path),
                          batch=8)
    assert [ln["phase"] for ln in lines] == [
        "train_grad", "train_prepare", "train_path", "train_chunk_vs_host",
        "train_times"]
    assert all(ln["ok"] for ln in lines)
    assert lines[0]["grad_rel_err_max"] == 0.0
    assert lines[3]["params_equal"] and lines[2]["latest_reads_back_equal"]
    assert set(out["counts"]) == {"k1", "k2", "k3", "k4",
                                  "unfused_shape_pass"}
    assert not any(out["counts"].values())
    assert out["train_steps_per_s"] > 0 and out["resident_bytes"] > 0


def test_profiling_helpers(tmp_path):
    """utils/profiling.py: the port's tracer replaces the JAX package's
    Timer, MetricsLogger and annotate (the JAX package keeps its own);
    trace() is a torch.profiler capture written to trace.json, with a
    program span of the capture in it."""
    from adaptigraph_torch.utils import profiling as tp
    from adaptigraph_tpu.utils import profiling as jp

    for name in ("Timer", "MetricsLogger", "annotate"):
        assert hasattr(jp, name) and not hasattr(tp, name)
    assert callable(tp.plot_loss_curves) and callable(jp.plot_loss_curves)
    with tp.trace(str(tmp_path / "trace")):
        with tp.span("matmul"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert '"matmul"' in text and "aten::mm" in text
    tp.reset()
