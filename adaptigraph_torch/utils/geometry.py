"""Quaternion / rotation utilities (torch, batched).

Counterpart of adaptigraph_tpu/utils/geometry.py. Quaternions are stored
``(x, y, z, w)``; every function broadcasts over leading batch dimensions
and keeps the JAX version's operation order, so the two agree to float32
rounding.
"""

from __future__ import annotations

import torch


def _norm(x, keepdim: bool = False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_from_axis_angle(axis, angle):
    """Unit quaternion (xyzw) for a rotation of `angle` rad about `axis`."""
    dev = next((t.device for t in (axis, angle) if torch.is_tensor(t)), None)
    axis = torch.as_tensor(axis, dtype=torch.float32, device=dev)
    axis = axis / (_norm(axis, keepdim=True) + 1e-12)
    half = torch.as_tensor(angle, dtype=torch.float32, device=dev) * 0.5
    xyz = axis * torch.sin(half)[..., None]
    w = torch.cos(half)[..., None].expand(xyz.shape[:-1] + (1,))
    return torch.cat([xyz, w], dim=-1)


def quat_multiply(q1, q2):
    """Hamilton product q1 * q2, both xyzw."""
    x1, y1, z1, w1 = torch.movedim(q1, -1, 0)
    x2, y2, z2, w2 = torch.movedim(q2, -1, 0)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q):
    return q / (_norm(q, keepdim=True) + 1e-12)


def quat_to_matrix(q):
    """Rotation matrix from xyzw quaternion; broadcasts to (..., 3, 3)."""
    x, y, z, w = torch.movedim(q, -1, 0)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4) with the
    matmul-free form v' = v + 2 q_v x (q_v x v + w v)."""
    qv, w = q[..., :3], q[..., 3:4]
    t = _cross(qv, _cross(qv, v) + w * v)
    return v + 2.0 * t


def quat_from_euler_xyz(rx, ry, rz):
    """Quaternion from intrinsic xyz Euler angles (rad), xyzw layout."""
    qx = quat_from_axis_angle([1.0, 0.0, 0.0], rx)
    qy = quat_from_axis_angle([0.0, 1.0, 0.0], ry)
    qz = quat_from_axis_angle([0.0, 0.0, 1.0], rz)
    return quat_multiply(quat_multiply(qx, qy), qz)


def matrix_to_quat(m):
    """xyzw quaternion from a rotation matrix (..., 3, 3); branchless."""
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    w = torch.sqrt(torch.clamp(1.0 + t, min=0.0)) / 2.0
    x = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) / 2.0
    y = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) / 2.0
    z = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) / 2.0

    def sgn(d):
        return torch.sign(torch.where(d == 0, torch.ones_like(d), d))

    x = x * sgn(m[..., 2, 1] - m[..., 1, 2])
    y = y * sgn(m[..., 0, 2] - m[..., 2, 0])
    z = z * sgn(m[..., 1, 0] - m[..., 0, 1])
    return quat_normalize(torch.stack([x, y, z, w], dim=-1))


def extract_rotation(A, q0, iterations: int = 8):
    """Rotational part of 3x3 deformation matrices A (..., 3, 3).

    Warm-started iterative quaternion method (Muller et al., "A Robust
    Method to Extract the Rotational Part of Deformations"), a fixed number
    of iterations from the previous rotation q0 (..., 4). Returns (..., 4)
    xyzw quaternions."""
    q = quat_normalize(q0)
    for _ in range(iterations):
        R = quat_to_matrix(q)
        cross = _cross(R[..., :, 0], A[..., :, 0])
        cross = cross + _cross(R[..., :, 1], A[..., :, 1])
        cross = cross + _cross(R[..., :, 2], A[..., :, 2])
        dot = (
            torch.sum(R[..., :, 0] * A[..., :, 0], dim=-1)
            + torch.sum(R[..., :, 1] * A[..., :, 1], dim=-1)
            + torch.sum(R[..., :, 2] * A[..., :, 2], dim=-1)
        )
        omega = cross / (torch.abs(dot)[..., None] + 1e-9)
        angle = _norm(omega)
        axis = omega / (angle[..., None] + 1e-9)
        dq = quat_from_axis_angle(axis, angle)
        q_new = quat_normalize(quat_multiply(dq, q))
        q = torch.where(angle[..., None] > 1e-9, q_new, q)
    return q


def rotation_2d_z(theta):
    """(..., 3, 3) rotation about +z by theta."""
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, z], dim=-1),
            torch.stack([s, c, z], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
