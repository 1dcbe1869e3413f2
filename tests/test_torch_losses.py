"""Port parity: the point-set distances of ops/losses.py against the JAX
package's, on the same inputs from numpy seeds.

Tolerances: chamfer, masked chamfer, Hausdorff and the box loss within
1e-6, the 50-iteration Sinkhorn earth mover's distance within 1e-5 (each
with and without masks; points within a unit cube, so a distance is of
order 1 and 1e-6 is a few float32 ulps of it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.ops import losses as jl
from adaptigraph_torch.ops import losses as tl

_ATOL, _EMD_ATOL = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores, and
    torch's thread pools, each sized to every core, slow each other down
    many times over (the numbers compared do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sets(seed, b=3, n=17, m=13):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, n, 3).astype(np.float32)
    y = rng.rand(b, m, 3).astype(np.float32)
    xm = rng.rand(b, n) < 0.7
    ym = rng.rand(b, m) < 0.6
    xm[:, 0] = ym[:, 0] = True
    return x, y, xm, ym


def _both(fn_j, fn_t, *arrays):
    j = np.asarray(fn_j(*(None if a is None else jnp.asarray(a)
                          for a in arrays)))
    t = fn_t(*(None if a is None else torch.as_tensor(a)
               for a in arrays)).numpy()
    return j, t


_MASKS = {"none": (False, False), "x": (True, False), "y": (False, True),
          "both": (True, True)}


@pytest.mark.parametrize("masks", sorted(_MASKS))
@pytest.mark.parametrize("name", ["chamfer", "hausdorff"])
def test_distance_matches_jax(name, masks):
    x, y, xm, ym = _sets(1)
    use_x, use_y = _MASKS[masks]
    j, t = _both(getattr(jl, name), getattr(tl, name), x, y,
                 xm if use_x else None, ym if use_y else None)
    assert t.shape == j.shape == (3,)
    np.testing.assert_allclose(t, j, rtol=0, atol=_ATOL)


def test_masked_chamfer_matches_jax():
    x, y, xm, ym = _sets(2, b=5)
    j, t = _both(jl.masked_chamfer, tl.masked_chamfer, x, y, xm, ym)
    np.testing.assert_allclose(t, j, rtol=0, atol=_ATOL)
    # a set masked out entirely counts as empty (the count floors at 1)
    xm[0] = False
    j, t = _both(jl.masked_chamfer, tl.masked_chamfer, x, y, xm, ym)
    np.testing.assert_allclose(t, j, rtol=0, atol=_ATOL)


def test_chamfer_broadcasts_one_target():
    x, y, xm, _ = _sets(3, b=4)
    j, t = _both(lambda a, b_, m: jl.chamfer(a, b_[None], x_mask=m),
                 lambda a, b_, m: tl.chamfer(a, b_[None], x_mask=m),
                 x, y[0], xm)
    np.testing.assert_allclose(t, j, rtol=0, atol=_ATOL)


@pytest.mark.parametrize("masks", sorted(_MASKS))
def test_earth_mover_distance_matches_jax(masks):
    x, y, xm, ym = _sets(4, n=11, m=11)
    use_x, use_y = _MASKS[masks]
    j, t = _both(jl.earth_mover_distance, tl.earth_mover_distance, x, y,
                 xm if use_x else None, ym if use_y else None)
    assert np.isfinite(t).all() and (t > 0).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=_EMD_ATOL)


def test_box_loss_matches_jax():
    rng = np.random.RandomState(5)
    state = (rng.rand(4, 23, 3) * 3 - 1.5).astype(np.float32)
    box = np.array([[-0.5, 0.4], [-0.2, 0.7]], np.float32)
    j, t = _both(jl.box_loss, tl.box_loss, state, box)
    np.testing.assert_allclose(t, j, rtol=0, atol=_ATOL)
    inside = np.zeros((1, 5, 3), np.float32)
    j, t = _both(jl.box_loss, tl.box_loss, inside, box)
    np.testing.assert_allclose(t, j, rtol=0, atol=_ATOL)
    assert t[0] < 1e-5  # sqrt(1e-12): inside the box
