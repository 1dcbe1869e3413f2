"""Port parity: farthest-point sampling (adaptigraph_torch/ops/fps.py)
against the JAX package's ops/fps.py on the CPU.

Every comparison is exact: the index lists, the keep masks and the
pre-selection distances equal JAX's, on random clouds with invalid points
and on rope-like lattices whose distances tie exactly. The two random
starts of fps_subsample are replayed from JAX's own key: r1 from k1 over
the valid count, r2 from k2 over the count stage 1 keeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.ops import fps as jf
from adaptigraph_torch.ops import fps as tf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice(nx=12, ny=4, nz=3, step=0.1):
    g = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij"), -1).reshape(-1, 3)
    return (g * step).astype(np.float32)


def _cloud(seed, n=300):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 3).astype(np.float32) * 3, rng.rand(n) > 0.2


def _jax_ranks(key, nvalid, max_n):
    """The two start ranks JAX's fps_subsample draws from `key`."""
    k1, k2 = jax.random.split(key)
    r1 = jax.random.randint(k1, (), 0, jnp.maximum(jnp.int32(nvalid), 1))
    r2 = jax.random.randint(k2, (), 0,
                            jnp.maximum(jnp.int32(min(nvalid, max_n)), 1))
    return [int(r1), int(r2)]


def _equal(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("case", ["cloud0", "cloud1", "lattice"])
def test_farthest_point_sampling_equals_jax(case):
    if case == "lattice":
        pts, valid, start = _lattice(), None, 0
    else:
        pts, valid = _cloud(int(case[-1]))
        start = int(np.flatnonzero(valid)[3])
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.as_tensor(valid)
    ji, jd = jf.farthest_point_sampling(jnp.asarray(pts), 60, start, jv)
    ti, td = tf.farthest_point_sampling(torch.as_tensor(pts), 60, start, tv)
    assert ti.dtype == torch.int32
    assert _equal(ji, ti) and _equal(jd, td)
    if valid is not None:
        assert valid[ti.numpy()].all()


def test_lattice_ties_need_the_fused_rounding(monkeypatch):
    """On the lattice a plain float32 sum of squares picks other points
    than XLA's fused multiply-adds: the port's rounding is what makes the
    index lists equal."""
    pts = _lattice()
    ji, _ = jf.farthest_point_sampling(jnp.asarray(pts), 60, 0)
    monkeypatch.setattr(tf, "_dist", lambda p, c: torch.sqrt(
        ((p - c[:, None]) ** 2).sum(-1)))
    ti, _ = tf.farthest_point_sampling(torch.as_tensor(pts), 60, 0)
    assert not _equal(ji, ti)


@pytest.mark.parametrize("case,radius,start", [
    ("lattice", 0.25, 3), ("lattice", 0.15, 0), ("cloud0", 0.9, 10)])
def test_fps_radius_equals_jax(case, radius, start):
    pts, valid = ((_lattice(), np.ones(144, bool)) if case == "lattice"
                  else _cloud(0))
    ji, jk = jf.fps_radius(jnp.asarray(pts), radius, 60, start,
                           jnp.asarray(valid))
    ti, tk = tf.fps_radius(torch.as_tensor(pts), radius, 60, start,
                           torch.as_tensor(valid))
    assert _equal(ji, ti) and _equal(jk, tk)
    assert 1 < int(tk.sum()) < 60


@pytest.mark.parametrize("seed", range(5))
def test_fps_subsample_equals_jax_with_its_ranks(seed):
    """Valid counts from 350 down to 110 (below max_n: stage 1 repeats
    points, which stage 2 masks out)."""
    pts = np.random.RandomState(seed).rand(400, 3).astype(np.float32) * 2
    valid = np.arange(400) < 350 - seed * 60
    key = jax.random.PRNGKey(seed)
    ji, jk = jf.fps_subsample(jnp.asarray(pts), 100, 0.2, key,
                              jnp.asarray(valid))
    ranks = _jax_ranks(key, int(valid.sum()), 100)
    ti, tk = tf.fps_subsample(torch.as_tensor(pts), 100, 0.2,
                              ranks=torch.tensor(ranks),
                              valid=torch.as_tensor(valid))
    assert _equal(ji, ti) and _equal(jk, tk)


def test_fps_subsample_on_a_lattice_equals_jax():
    pts = _lattice()
    key = jax.random.PRNGKey(4)
    ji, jk = jf.fps_subsample(jnp.asarray(pts), 100, 0.25, key)
    ti, tk = tf.fps_subsample(torch.as_tensor(pts), 100, 0.25,
                              ranks=torch.tensor(_jax_ranks(key, 144, 100)))
    assert _equal(ji, ti) and _equal(jk, tk)


def test_fps_subsample_draws_its_starts_from_a_generator():
    pts, valid = _cloud(2)
    a = tf.fps_subsample(torch.as_tensor(pts), 50, 0.4,
                         valid=torch.as_tensor(valid),
                         generator=torch.Generator().manual_seed(5))
    b = tf.fps_subsample(torch.as_tensor(pts), 50, 0.4,
                         valid=torch.as_tensor(valid),
                         generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    kept = a[0][a[1]].numpy()
    assert valid[kept].all() and len(np.unique(kept)) == len(kept)


def test_start_ranks_stay_in_range():
    u = torch.tensor([[0.0, 0.0], [0.9999999, 0.9999999], [0.5, 0.5]])
    r = tf.start_ranks(u, torch.tensor([0, 7, 300]), 100)
    assert r.tolist() == [[0, 0], [6, 6], [150, 50]]


def test_batched_forms_equal_a_loop_over_samples():
    """Per-sample starts, radii, masks and ranks in one batch against one
    call a sample."""
    rng = np.random.RandomState(7)
    b, n = 5, 250
    pts = torch.as_tensor(rng.rand(b, n, 3).astype(np.float32) * 2)
    valid = torch.as_tensor(np.arange(n)[None] < rng.randint(80, n, (b, 1)))
    starts = torch.tensor([0, 3, 17, 40, 79])
    radius = torch.as_tensor(rng.uniform(0.15, 0.4, b).astype(np.float32))
    ranks = tf.start_ranks(torch.as_tensor(rng.rand(b, 2)), valid.sum(1), 100)
    bi, bd = tf.farthest_point_sampling_batch(pts, 40, starts, valid)
    ri, rk = tf.fps_radius_batch(pts, radius, 40, starts, valid)
    si, sk = tf.fps_subsample_batch(pts, 100, radius, ranks, valid)
    for i in range(b):
        oi, od = tf.farthest_point_sampling(pts[i], 40, starts[i], valid[i])
        assert torch.equal(bi[i], oi) and torch.equal(bd[i], od)
        oi, ok = tf.fps_radius(pts[i], radius[i], 40, starts[i], valid[i])
        assert torch.equal(ri[i], oi) and torch.equal(rk[i], ok)
        oi, ok = tf.fps_subsample(pts[i], 100, radius[i], ranks[i], valid[i])
        assert torch.equal(si[i], oi) and torch.equal(sk[i], ok)
