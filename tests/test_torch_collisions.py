"""Port parity: adaptigraph_torch.engine.collisions.shape_contact_deltas
against the JAX pass, for plane, box, capsule and convex shapes.

Particles are scattered around each shape so some penetrate and some do
not. Contact counts must be equal; deltas agree to float32 rounding of the
rotations and norms (atol 1e-6)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptigraph_tpu.engine import collisions as jcol
from adaptigraph_tpu.engine import state as jstate
from adaptigraph_torch.engine import collisions as tcol
from adaptigraph_torch.engine import state as tstate

_CUBE = [[1, 0, 0, 0.1], [-1, 0, 0, 0.1], [0, 1, 0, 0.1], [0, -1, 0, 0.1],
         [0, 0, 1, 0.1], [0, 0, -1, 0.1]]
_SHAPES = {
    "plane": (jstate.SHAPE_PLANE, [0, 0, 0], None),
    "box": (jstate.SHAPE_BOX, [0.2, 0.1, 0.3], None),
    "capsule": (jstate.SHAPE_CAPSULE, [0.08, 0.2, 0.0], None),
    "convex": (jstate.SHAPE_CONVEX, [0, 0, 0], _CUBE),
}


@pytest.mark.parametrize("kind", sorted(_SHAPES))
def test_shape_contact_deltas_match_jax(kind):
    rng = np.random.RandomState(3)
    code, size, planes = _SHAPES[kind]
    m = 2  # the shape under test plus a far-away box, as scenes pad shapes
    kinds = [code, jstate.SHAPE_BOX]
    sizes = [size, [0.1, 0.1, 0.1]]
    poses = [[0.1, 0.05, -0.1], [5.0, 5.0, 5.0]]
    q = rng.randn(4).astype(np.float32)
    quats = [q / np.linalg.norm(q), [0, 0, 0, 1]]
    pl = None if planes is None else [planes, None]
    j_sh = jstate.make_shapes(kinds, sizes, poses, quats, m_max=m, planes=pl)
    t_sh = tstate.make_shapes(kinds, sizes, poses, quats, m_max=m, planes=pl,
                              device="cpu")

    n = 400
    pos = (rng.randn(n, 3) * 0.2 + poses[0]).astype(np.float32)
    prev = pos - rng.randn(n, 3).astype(np.float32) * 0.01
    s_vel = rng.randn(m, 3).astype(np.float32)
    cd, margin, fr, dt = 0.015, 0.0, 0.3, 1.0 / 120.0
    jd, jc = jcol.shape_contact_deltas(
        jnp.asarray(pos), jnp.asarray(prev), j_sh, j_sh.pos, j_sh.quat,
        jnp.asarray(s_vel), jnp.float32(cd), margin, jnp.float32(fr),
        jnp.float32(dt))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    td, tc = tcol.shape_contact_deltas(
        torch.as_tensor(pos), torch.as_tensor(prev), t_sh, t_sh.pos,
        t_sh.quat, torch.as_tensor(s_vel), f32(cd), margin, f32(fr), f32(dt))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert 0 < tc.sum() < n  # some particles touch, some do not
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=0, atol=1e-6)
