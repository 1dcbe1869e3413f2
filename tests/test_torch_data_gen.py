"""Port parity: episode generation (sim/data_gen.py), the episode form
(sim/episode_io.py) and preprocess() (dynamics/preprocess.py) against the
JAX package on the CPU, and chip_smoke.py's sim phases rehearsed on the
CPU.

The port writes one `NN.npz` a push where JAX writes `NN.h5` (the card's
machine has no h5py): the same dataset paths as keys, the same dtypes.
So an episode of the port, written to h5 through JAX's save_data and read
back by JAX's load_data, must equal the port's load_data; and JAX's
preprocess() over that h5 copy must give the port's preprocess()'s
frame pairs, metadata and physics range exactly, and its positions
within 1e-6. Both packages' episodes come from tests/test_torch_sim.py's
tiny clustered block and the same seed: the same captured frame counts,
the settled positions within 1e-4, the first push within 5e-4 and its
captures equal but for values off by one, the second push (whose action
is sampled from the first's result) within the cascade's bounds stated
in test_gen_episode_matches_jax.
"""

import glob
import os
import pickle
import shutil
import time
import types

import numpy as np
import pytest
import torch

import adaptigraph_tpu.sim.data_gen as jgen
import adaptigraph_torch.sim.data_gen as tgen
from adaptigraph_tpu.dynamics.preprocess import preprocess as j_preprocess
from adaptigraph_tpu.sim import episode_io as jio
from adaptigraph_tpu.utils import Config
from adaptigraph_tpu.utils import load_config as j_load_config
from adaptigraph_torch.dynamics.preprocess import preprocess as t_preprocess
from adaptigraph_torch.sim import episode_io as tio
from adaptigraph_torch.utils import load_config as t_load_config
from tests.test_torch_sim import TINY, _images_close, patch_tiny

N_PUSH = 2
# an episode of the tiny block whose two pushes both find an action (episode
# 0's second finds none, in both packages, and stops there)
SEED = 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    """Nested episode dicts equal key for key, value for value and dtype."""
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], dict):
            _same(a[key], b[key])
        else:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)


def test_episode_form_round_trips_through_jax_h5(tmp_path):
    rng = np.random.RandomState(0)
    t, c, h, w = 3, 4, 16, 16
    floats = [rng.rand(c, h, w, 5).astype(np.float32) for _ in range(t)]
    pairs = [((rng.rand(c, h, w, 3) * 255).astype(np.uint8),
              (rng.rand(c, h, w) * 9000).astype(np.uint16)) for _ in range(t)]
    for imgs in (floats, pairs):
        for a, b in zip(tio.process_imgs(imgs), jio.process_imgs(imgs)):
            _same(a, b)
        data = (imgs, [rng.rand(50, 3).astype(np.float32) for _ in range(t)],
                [rng.rand(1, 14).astype(np.float32) for _ in range(t)])
        npz, h5 = tmp_path / "00.npz", tmp_path / "00.h5"
        tio.store_data(str(npz), data, np.array([1.0, 2, 3, 4]))
        jio.store_data(str(tmp_path / "ref.h5"), data, np.array([1.0, 2, 3, 4]))
        port = tio.load_data(str(npz))
        assert port["info"]["n_cams"] == c and port["info"]["timestamp"] == t
        assert port["observations"]["depth"]["cam_0"].dtype == np.uint16
        # the port's episode written to h5 by JAX, and read back by JAX
        jio.save_data(str(h5), port)
        _same(jio.load_data(str(h5)), port)
        _same(jio.load_data(str(tmp_path / "ref.h5")), port)


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    """Episode SEED of the tiny block, N_PUSH pushes, from each package."""
    root = tmp_path_factory.mktemp("episodes")
    cfg = {"dataset": dict(TINY, n_timestep=N_PUSH, base=SEED)}
    with pytest.MonkeyPatch.context() as mp:
        patch_tiny(mp)
        je = jgen.gen_episode(Config(cfg), SEED, True, str(root / "jax"))
        te = tgen.gen_episode(cfg, SEED, True, str(root / "port"),
                              device="cpu")
        yield root, je, te, cfg


def test_gen_episode_matches_jax(episodes):
    root, je, te, cfg = episodes
    epi = f"{SEED:06}"
    jdir, tdir = root / "jax" / "rope" / epi, root / "port" / "rope" / epi
    assert sorted(os.listdir(tdir)) == ["00.npz", "01.npz", "02.npz",
                                        "property_params.pkl",
                                        "resume_state.npz"]
    assert te.episode_stats["pushes_run"] >= N_PUSH
    assert not te.episode_stats["stuck"]
    for cam in ("intrinsic", "extrinsic"):
        np.testing.assert_array_equal(
            np.load(root / "port" / "rope" / "cameras" / f"{cam}.npy"),
            np.load(root / "jax" / "rope" / "cameras" / f"{cam}.npy"))
    assert tio.load_property_params(str(tdir)) == jio.load_property_params(
        str(jdir))
    # the settled scene to 1e-4; the first push, whose action is sampled
    # from positions within 5e-7, to 5e-4 (its action 3e-7 apart meets the
    # block at a contact onset, which amplifies it: 1.3e-4); the second
    # push's action follows a particle of the first push's end, so it
    # cascades: its start is the same rng draw, its end within 1e-3
    # (4.8e-4) and its positions within 1e-2 (3.0e-3)
    for i, atol in enumerate((1e-4, 5e-4, 1e-2)):
        t, j = tio.load_data(str(tdir / f"{i:02}.npz")), jio.load_data(
            str(jdir / f"{i:02}.h5"))
        np.testing.assert_array_equal(t["action"][:2], j["action"][:2])
        np.testing.assert_allclose(t["action"], j["action"], rtol=0,
                                   atol=1e-5 if i < 2 else 1e-3)
        assert t["positions"].shape == j["positions"].shape  # frame counts
        np.testing.assert_allclose(t["positions"], j["positions"], rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(t["eef_states"], j["eef_states"], rtol=0,
                                   atol=atol)
        for kind in ("color", "depth"):
            for cam in j["observations"][kind]:
                a = t["observations"][kind][cam]
                b = j["observations"][kind][cam]
                assert a.dtype == b.dtype and a.shape == b.shape
                if i < 2:
                    _images_close([(a, a)], [(b, b)])
    moved = np.abs(tio.load_data(str(tdir / f"{N_PUSH:02}.npz"))["positions"][-1]
                   - tio.load_data(str(tdir / "00.npz"))["positions"][0])
    assert moved.max() > 0.05


def test_resume_state_round_trips(episodes):
    """A fresh env of the same seed, reset without its settle, takes the
    episode's last state from the resume file."""
    root, _, te, cfg = episodes
    tdir = str(root / "port" / "rope" / f"{SEED:06}")
    with pytest.MonkeyPatch.context() as mp:
        patch_tiny(mp)
        env = tgen.SimEnv(cfg, device="cpu")
        env.reset(seed=SEED, save_data=False, settle=False)
        env.finish_reset(save_data=False)
        assert tgen._load_resume_state(env, tdir) == N_PUSH
    for a, b in ((env.state.particles, te.state.particles),
                 (env.state.shapes, te.state.shapes)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(env.state.cluster_rot, te.state.cluster_rot)
    np.testing.assert_array_equal(env.sampled_idx, te.sampled_idx)


def test_preprocess_matches_jax_on_the_h5_copy(episodes, tmp_path):
    root, _, _, _ = episodes
    src = root / "port" / "rope" / f"{SEED:06}"
    # the port's episode as written and converted to JAX's h5, twice: in
    # full, and cut after its first push
    for name in ("port", "jax"):
        for epi in ("000000", "000001"):
            dst = tmp_path / name / "rope" / epi
            dst.mkdir(parents=True)
            shutil.copy(src / "property_params.pkl", dst)
            for f in sorted(glob.glob(str(src / "[0-9][0-9].npz"))):
                step = os.path.basename(f)[:2]
                if epi == "000001" and step == "02":
                    continue
                if name == "port":
                    shutil.copy(f, dst)
                else:
                    jio.save_data(str(dst / f"{step}.h5"), tio.load_data(f))
    out = {}
    for name, load, prep in (("port", t_load_config, t_preprocess),
                             ("jax", j_load_config, j_preprocess)):
        cfg = load("dynamics/rope")
        cfg["dataset_config"]["data_dir"] = str(tmp_path / name)
        cfg["dataset_config"]["prep_data_dir"] = str(tmp_path / f"{name}_prep")
        prep(cfg)
        out[name] = tmp_path / f"{name}_prep" / "rope"
    t, j = out["port"], out["jax"]
    pairs = sorted(os.listdir(t / "frame_pairs"))
    assert pairs == sorted(os.listdir(j / "frame_pairs")) and len(pairs) == 3
    for f in pairs:
        assert (t / "frame_pairs" / f).read_text() == (
            j / "frame_pairs" / f).read_text()
    for f in ("metadata.txt", "phys_range.txt"):
        assert (t / f).read_text() == (j / f).read_text()
    pt = pickle.loads((t / "positions.pkl").read_bytes())
    pj = pickle.loads((j / "positions.pkl").read_bytes())
    for key in ("eef_pos", "obj_pos"):
        assert len(pt[key]) == len(pj[key]) == 2
        for a, b in zip(pt[key], pj[key]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_smoke_sim_path_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's sim phases, rehearsed with the CPU in the card's
    place on the tiny block (its lattice closer than the contact distance),
    forced into the block contact mode (so K1
    and K2's plain versions run where the card launches the kernels),
    with counters on the contact wrappers and a stand-in library for
    the raw launches the kernel times take: every gate holds, as card and
    CPU are then one device."""
    import chip_smoke as cs
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine import solver
    from adaptigraph_torch.kernels import build
    from adaptigraph_torch.tools import profile_frame

    # the block at a spacing below the contact distance, so that the
    # kernel check's frame has particle contacts
    patch_tiny(monkeypatch, spacing=0.025)
    monkeypatch.setattr(solver, "auto_contact_mode", lambda n: "block")
    for name in ("block_sparse_contact_deltas_packed",
                 "refine_overlap_blocks_packed", "dense_contact_deltas_packed"):
        real = getattr(ck, name)

        def counted(*a, _real=real, **k):
            _real.launches += 1
            return _real(*a, **k)

        monkeypatch.setattr(solver, name, counted)

    def host_ms(fn, reps, warm=1):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)

    def host_profile(fn, frames):
        t0 = time.perf_counter()
        fn()
        return {"wall_ms_per_frame": 1e3 * (time.perf_counter() - t0) / frames,
                "device_busy_ms_per_frame": 0.0, "device_idle_share": 1.0,
                "kernel_launches_per_frame": 0.0, "top_kernels": []}

    monkeypatch.setattr(cs, "event_ms", host_ms)
    monkeypatch.setattr(profile_frame, "profiled", host_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(build, "check", lambda *a: None)
    monkeypatch.setattr(build, "launch_geometry", lambda *a: {})
    lib = types.SimpleNamespace(ag_block_sparse_contact=lambda *a: 0,
                                ag_refine_blocks=lambda *a: 0)
    out = cs.sim_phases("cpu", lib, config={"dataset": dict(TINY)}, seed=0)
    counts = out["counts"]
    assert counts["k2"] > 0 and counts["k1"] == 4 * counts["k2"]
    assert counts["k3"] == counts["k4"] == 0
    assert out["k1_err"] == 0.0
    assert set(out["times"]) == {"k1", "k1_b", "k1_plain_a", "k1_plain_b",
                                 "k2", "k2_b", "k2_plain_a", "k2_plain_b"}
    assert out["detail"]["k1"]["contacts"] > 0
