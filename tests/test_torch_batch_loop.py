"""The batch's port-only cases on the CPU: env 0 of a BatchSimEnv whose
cluster matrix the batch re-padded, against a lone SimEnv; the CLI and the
device rule; and chip_smoke.py's batch phase rehearsed at a tiny size.

The JAX parity of the batch is tests/test_torch_batch_env.py; these cases
run tests/test_torch_sim.py's tiny block in the port alone. A re-padded
cluster matrix changes its matmul's inner dimension, so env 0 is held
within 1e-4 of the lone env there (bit for bit where nothing is
re-padded: tests/test_torch_batch_env.py).
"""

import numpy as np
import pytest
import torch

import adaptigraph_torch.sim.batch_env as tbatch
import adaptigraph_torch.sim.env as tenv
from adaptigraph_torch.engine import state as tstate
from tests.test_torch_batch_env import BATCH, SEEDS, _ATOL, _lone_push
from tests.test_torch_sim import PUSH, _close, _port_build, patch_tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clusters_by_seed(material, rng, shapes=None, caps=None, device=None):
    """The tiny block held by one cluster (the matrix trimmed to 8 rows)
    or, for an odd first draw, by nine clusters of four (16 rows)."""
    b = _port_build(material, rng, shapes=shapes, caps=caps, device=device)
    pts = b.spec.rest_pos[:36].numpy()
    members = ([np.arange(36)] if rng.randint(2) == 0
               else [np.arange(4 * k, 4 * k + 4) for k in range(9)])
    cl = tstate.make_clusters(members, pts, 1.0, c_max=16, k_max=64,
                              device=device)
    spec = b.spec._replace(clusters=cl, cluster_mm=tstate.build_cluster_matmul(
        cl, b.spec.rest_pos, 64))
    state = b.state._replace(cluster_rot=torch.tensor(
        [[0.0, 0, 0, 1.0]], device=device).repeat(16, 1))
    return b._replace(spec=tstate.trim_cluster_matmul(spec), state=state)


def test_env0_repadded_against_a_lone_simenv(monkeypatch):
    """Env 0's cluster matrix re-padded from 8 rows to env 1's 16: its
    settle and push within 1e-4 of a lone SimEnv's."""
    patch_tiny(monkeypatch)
    monkeypatch.setattr(tenv, "build_scene", _clusters_by_seed)
    seeds = [s for s in range(40)
             if np.random.RandomState(s).randint(2) == 0][:1] + [
        s for s in range(40) if np.random.RandomState(s).randint(2) == 1][:1]
    cfg = {"dataset": dict(BATCH)}
    tb = tbatch.BatchSimEnv(cfg, batch=2, device="cpu")
    tb.reset(seeds)
    assert tb.repadded == [True, False]
    assert [e.spec.cluster_mm.matrix.shape[0] for e in tb.envs] == [16, 16]
    settled_b = tb.envs[0].state.particles.pos.clone()
    rec_b, _, _ = tb.run_pushes([PUSH, None])
    settled, rec, _ = _lone_push(cfg, seeds[0], PUSH)
    _close(settled_b, settled, _ATOL)
    _close(rec_b[0], rec, _ATOL)
    assert np.abs(rec_b[0][-1] - settled_b.numpy()).max() > 0.01


def test_batch_cli_device_rule(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.BatchSimEnv({"dataset": dict(BATCH)}, batch=2)
    calls = []
    monkeypatch.setattr(tbatch, "generate_batch",
                        lambda cfg, seeds, out, device=None: calls.append(
                            (seeds, out, device)))
    tbatch.main(["--seeds", "3,4,5", "--batch", "2", "--out", str(tmp_path),
                 "--device", "cpu"])
    assert calls == [([3, 4], str(tmp_path), "cpu"),
                     ([5], str(tmp_path), "cpu")]


# ---------- the smoke's batch phase on the CPU ----------

def test_smoke_batch_path_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's batch phase with the CPU in the card's place on the
    tiny block forced into the block contact mode, counters on the
    contact wrappers: two seeds' episodes written and read back, env 0's
    push records equal to the lone run's, K1 4 and K2 1 a frame (the
    tiny block's 2 x 2 iterations)."""
    import chip_smoke as cs
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine import solver

    patch_tiny(monkeypatch, spacing=0.025)
    monkeypatch.setattr(solver, "auto_contact_mode", lambda n: "block")
    for name in ("block_sparse_contact_deltas_packed",
                 "refine_overlap_blocks_packed", "dense_contact_deltas_packed"):
        real = getattr(ck, name)

        def counted(*a, _real=real, **k):
            _real.launches += 1
            return _real(*a, **k)

        monkeypatch.setattr(solver, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = {"dataset": dict(BATCH, n_timestep=1)}
    env = tenv.SimEnv(cfg, device="cpu")  # the lone run: the sim path's part
    lone = cs.keep_pushes(env)
    env.reset(seed=SEEDS[0])
    env.step(env.sample_action())
    out = cs.batch_phases("cpu", config=cfg, seeds=SEEDS, lone=lone)
    counts = out["counts"]
    assert counts["k2"] == out["env_frames"] and counts["k1"] == 4 * counts["k2"]
    assert counts["k3"] == counts["k4"] == 0
    assert out["env0_equal"] and out["episodes_read"] == 2
