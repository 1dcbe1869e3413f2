"""Port parity: adaptigraph_torch.utils.geometry against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. Tolerance:
float32 rounding of a few chained products (atol 1e-6) and, for the
iterative polar decomposition, of six to eight warm-started iterations
(atol 1e-5)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptigraph_tpu.utils import geometry as jgeo
from adaptigraph_torch.utils import geometry as tgeo


def _quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _close(j, t, atol):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["quat_multiply", "quat_conjugate",
                                  "quat_normalize", "quat_to_matrix",
                                  "quat_rotate", "matrix_to_quat"])
def test_quaternion_algebra_matches_jax(name):
    rng = np.random.RandomState(0)
    q1, q2 = _quats(rng, 64), _quats(rng, 64) * 1.7
    v = rng.randn(64, 3).astype(np.float32)
    args = {
        "quat_multiply": (q1, q2),
        "quat_conjugate": (q2,),
        "quat_normalize": (q2,),
        "quat_to_matrix": (q1,),
        "quat_rotate": (q1, v),
        "matrix_to_quat": (np.array(jgeo.quat_to_matrix(q1)),),
    }[name]
    j = getattr(jgeo, name)(*(jnp.asarray(a) for a in args))
    t = getattr(tgeo, name)(*(torch.as_tensor(a) for a in args))
    _close(j, t, 1e-6)


def test_axis_angle_euler_and_rotation_2d_match_jax():
    rng = np.random.RandomState(1)
    axis = rng.randn(32, 3).astype(np.float32)
    ang = rng.uniform(-3, 3, 32).astype(np.float32)
    _close(jgeo.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(ang)),
           tgeo.quat_from_axis_angle(torch.as_tensor(axis), torch.as_tensor(ang)),
           1e-6)
    rx, ry, rz = (rng.uniform(-3, 3, 32).astype(np.float32) for _ in range(3))
    _close(jgeo.quat_from_euler_xyz(*(jnp.asarray(a) for a in (rx, ry, rz))),
           tgeo.quat_from_euler_xyz(*(torch.as_tensor(a) for a in (rx, ry, rz))),
           1e-6)
    _close(jgeo.rotation_2d_z(jnp.asarray(rx)),
           tgeo.rotation_2d_z(torch.as_tensor(rx)), 1e-6)


@pytest.mark.parametrize("iterations", [6, 8])
def test_extract_rotation_warm_started_matches_jax(iterations):
    """Deformation matrices A = R S (S symmetric positive), warm-started
    from a rotation near R, as the solver calls it every iteration."""
    rng = np.random.RandomState(2)
    q_true = _quats(rng, 48)
    r_true = np.asarray(jgeo.quat_to_matrix(jnp.asarray(q_true)))
    s = rng.randn(48, 3, 3).astype(np.float32) * 0.2
    s = np.eye(3, dtype=np.float32) + 0.5 * (s + s.transpose(0, 2, 1))
    a = (r_true @ s).astype(np.float32)
    q0 = q_true + rng.randn(48, 4).astype(np.float32) * 0.1
    j = jgeo.extract_rotation(jnp.asarray(a), jnp.asarray(q0), iterations)
    t = tgeo.extract_rotation(torch.as_tensor(a), torch.as_tensor(q0), iterations)
    _close(j, t, 1e-5)
