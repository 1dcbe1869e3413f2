"""xArm6 kinematics in torch: the port of adaptigraph_tpu/sim/robot.py.

The chain is a fixed 6-joint kinematic tree (joint origins and axes from
the xArm6 URDF: joint1 z+0.267, joint2 rpy -pi/2 about x, joint3 xyz
(0.0535, -0.2845, 0), joint4 xyz (0.0775, 0.3425, 0) rpy -pi/2, joint5 rpy
+pi/2, joint6 xyz (0.076, 0.097, 0) rpy -pi/2; all revolute about local z)
in the scaled FleX world frame (URDF meters x 10, the bullet -> flex axis
swap folded into the base transform). FK is a 6-step matrix chain over
any leading batch dimensions; IK is damped least squares with the
Jacobian written out by hand and a fixed number of iterations, run on
the device of its inputs. Every product runs in full float32 (TF32 off).

The link hulls come from `xarm6_links.txt` beside this module, a text copy
of data/assets/xarm6_links.npz, so the arm needs no `data/` directory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from adaptigraph_torch.utils import geometry as geo
from adaptigraph_torch.utils.device import full_f32_matmul

# joint origin translations (URDF meters) and fixed rpy rotations
_JOINT_XYZ = np.array([
    [0.0, 0.0, 0.267],
    [0.0, 0.0, 0.0],
    [0.0535, -0.2845, 0.0],
    [0.0775, 0.3425, 0.0],
    [0.0, 0.0, 0.0],
    [0.076, 0.097, 0.0],
], dtype=np.float32)
_JOINT_RPY_X = np.array([0.0, -np.pi / 2, 0.0, -np.pi / 2, np.pi / 2, -np.pi / 2],
                        dtype=np.float32)
JOINT_LOWER = np.array([-6.2832, -2.059, -3.927, -6.2832, -1.69297, -6.2832],
                       dtype=np.float32)
JOINT_UPPER = np.array([6.2832, 2.0944, 0.19198, 6.2832, 3.14159, 6.2832],
                       dtype=np.float32)

# bullet (z-up) -> flex (y-up) rotation (robot_env.py:12-16)
_B2F = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]], dtype=np.float32)

_ASSETS_TXT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "xarm6_links.txt")


def _rx(a):
    """Rotations about x for the fixed joint angles, (..., 3, 3)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([torch.stack([o, z, z], -1),
                        torch.stack([z, c, -s], -1),
                        torch.stack([z, s, c], -1)], -2)


def _rz(a):
    """Rotations about z, (..., 3, 3), for angles (...)."""
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([c, -s, z, s, c, z, z, z, o], -1).unflatten(-1, (3, 3))


_CONSTS = {}


def _consts(device):
    """The chain's constant tensors on `device`, made once a device: the
    base rotation, the fixed x rotations (their cos and sin taken on the
    CPU, so every device's chain starts from the same bits), the joint
    offsets in URDF meters, the joint limits and the 6 x 6 identity."""
    key = str(device)
    if key not in _CONSTS:
        cpu = {"b2f": torch.as_tensor(_B2F),
               "rx": _rx(torch.as_tensor(_JOINT_RPY_X)),
               "offs": torch.as_tensor(_JOINT_XYZ),
               "lower": torch.as_tensor(JOINT_LOWER),
               "upper": torch.as_tensor(JOINT_UPPER),
               "eye": torch.eye(6)}
        _CONSTS[key] = {k: v.to(device) for k, v in cpu.items()}
    return _CONSTS[key]


def _as_f32(x, device):
    if not torch.is_tensor(x):
        x = np.array(x, dtype=np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def fk_link_poses(joints, base_pos, scale: float = 10.0):
    """Forward kinematics of the 6-link chain, in the flex world frame.

    Args:
      joints: (..., 6) joint angles (rad), a tensor.
      base_pos: (3,) robot base position in flex coords.
      scale: globalScaling (URDF meters -> world units).

    Returns: (link_pos (..., 7, 3), link_rot (..., 7, 3, 3)), base + 6 links.
    """
    full_f32_matmul()
    c = _consts(joints.device)
    batch = joints.shape[:-1]
    pos = _as_f32(base_pos, joints.device).expand(batch + (3,))
    rot = c["b2f"].expand(batch + (3, 3))
    rx = c["rx"]
    offs = c["offs"] * scale
    rz = _rz(joints)
    poses_p, poses_r = [pos], [rot]
    for i in range(6):
        pos = pos + (rot @ offs[i, :, None])[..., 0]
        rot = rot @ rx[i] @ rz[..., i, :, :]
        poses_p.append(pos)
        poses_r.append(rot)
    return torch.stack(poses_p, -2), torch.stack(poses_r, -3)


def fk_eef(joints, base_pos, scale: float = 10.0):
    p, r = fk_link_poses(joints, base_pos, scale)
    return p[..., -1, :], r[..., -1, :, :]


def _ik_update(q, target_pos, target_rot, base_pos, scale, rot_weight,
               damping_sq):
    """One damped-least-squares step toward a 6-DoF eef target. The
    error is [p - p_t, rot_weight * vee(R_t^T R - R^T R_t) / 2]; its
    Jacobian is written out: joint i turns about its link's z axis w_i
    through the link origin o_i, so dp/dq_i = w_i x (p - o_i) and
    dR/dq_i = [w_i]x R (the JAX package takes the same Jacobian with
    jax.jacfwd)."""
    p, r = fk_link_poses(q, base_pos, scale)
    pe, re = p[-1], r[-1]
    rt_t = target_rot.T

    def vee_skew(m):
        return 0.5 * torch.stack([m[..., 2, 1] - m[..., 1, 2],
                                  m[..., 0, 2] - m[..., 2, 0],
                                  m[..., 1, 0] - m[..., 0, 1]], -1)

    e = torch.cat([pe - target_pos, rot_weight * vee_skew(rt_t @ re)])
    w = r[1:, :, 2]  # (6, 3) joint axes in world
    j_pos = torch.linalg.cross(w, pe - p[1:], dim=-1)  # (6, 3)
    # [w]x R, column by column: w x R[:, k]
    d_r = torch.linalg.cross(w[:, None, :].expand(6, 3, 3), re.T[None],
                             dim=-1).transpose(-1, -2)
    j_rot = rot_weight * vee_skew(rt_t @ d_r)  # (6, 3)
    jac = torch.cat([j_pos, j_rot], -1).T  # (6 errors, 6 joints)
    c = _consts(q.device)
    jtj = jac.T @ jac + damping_sq * c["eye"]
    # solve_ex: no host sync to check the factorisation (jtj is SPD)
    dq = torch.linalg.solve_ex(jtj, (jac.T @ e)[:, None])[0][:, 0]
    return torch.clamp(q - dq, c["lower"], c["upper"])


def ik_solve(target_pos, target_rot, q0, base_pos, iters: int = 30,
             scale: float = 10.0, damping: float = 0.1,
             rot_weight: float = 0.3, device=None):
    """Damped-least-squares IK toward a 6-DoF end-effector target, on
    `device` (default: q0's device when q0 is a tensor, else the CPU).

    Args:
      target_pos: (3,) flex-frame eef position.
      target_rot: (3, 3) flex-frame eef rotation.
      q0: (6,) warm-start joint angles.
    Returns: (6,) joint angles clipped to limits.
    """
    dev = device or (q0.device if torch.is_tensor(q0) else "cpu")
    tp, tr = _as_f32(target_pos, dev), _as_f32(target_rot, dev)
    base = _as_f32(base_pos, dev)
    q = _as_f32(q0, dev)
    for _ in range(iters):
        q = _ik_update(q, tp, tr, base, scale, rot_weight, damping ** 2)
    return q


def ik_traj(eef_pos_traj, eef_rot_traj, q0, base_pos,
            iters_per_step: int = 6, scale: float = 10.0, device=None):
    """Joint trajectory tracking an end-effector trajectory: one DLS update
    block per frame, warm-started from the previous frame (the tool
    trajectory is scripted, so IK never depends on particle state). A host
    loop over the frames on `device` (default: q0's device when q0 is a
    tensor, else the CPU); it never syncs with the host.

    Args: eef_pos_traj (T, 3), eef_rot_traj (T, 3, 3) flex-frame targets,
      q0 (6,) initial joints, base_pos (3,).
    Returns: (T, 6) joint angles."""
    dev = device or (q0.device if torch.is_tensor(q0) else "cpu")
    tps = _as_f32(eef_pos_traj, dev)
    trs = _as_f32(eef_rot_traj, dev)
    base = _as_f32(base_pos, dev)
    q = _as_f32(q0, dev)
    out = []
    for t in range(tps.shape[0]):
        for _ in range(iters_per_step):
            q = _ik_update(q, tps[t], trs[t], base, scale, 0.3, 0.01)
        out.append(q)
    return torch.stack(out)


def link_pose_traj(q_traj, base_pos, scale: float = 10.0):
    """Batched FK: (T, 6) joints -> link poses (T, 7, 3) + quats (T, 7, 4)
    for the arm's kinematic collision and render shapes."""
    p, r = fk_link_poses(q_traj, base_pos, scale)
    return p, geo.matrix_to_quat(r)


_ARM_ASSETS = None


def read_arm_text(path: str = _ASSETS_TXT) -> dict:
    """The arm's link arrays as stored, {link names, '<link>_<part>':
    float32 array} (the npz's keys), from the text copy."""
    out, links = {}, []
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines()
                 if ln and not ln.startswith("#")]
    i = 0
    while i < len(lines):
        name, part, rows, cols = lines[i].split()
        rows, cols = int(rows), int(cols)
        block = np.array([ln.split() for ln in lines[i + 1: i + 1 + rows]],
                         dtype=np.float32)
        out[f"{name}_{part}"] = block.reshape(rows, cols)
        if name not in links:
            links.append(name)
        i += 1 + rows
    out["links"] = np.array(links)
    return out


def load_arm_assets(scale: float = 10.0):
    """The xArm6 link convex hulls + surface samples. Halfspaces n.x <= d
    scale to world units as d * scale. Returns {links, planes: list of 7
    (P, 4) arrays, surf: list of (S, 3), surf_n: list of (S, 3)} in
    link-local world units, as the JAX package's load_arm_assets does."""
    global _ARM_ASSETS
    if _ARM_ASSETS is not None and _ARM_ASSETS[0] == scale:
        return _ARM_ASSETS[1]
    raw = read_arm_text()
    links = [str(x) for x in raw["links"]]
    planes, surf, surf_n = [], [], []
    for name in links:
        p = raw[f"{name}_planes"].astype(np.float32).copy()
        p[:, 3] *= scale
        planes.append(p)
        surf.append(raw[f"{name}_surf"].astype(np.float32) * scale)
        surf_n.append(raw[f"{name}_surf_n"].astype(np.float32))
    out = {"links": links, "planes": planes, "surf": surf, "surf_n": surf_n}
    _ARM_ASSETS = (scale, out)
    return out


def pusher_orientation(pusher_angle):
    """Flex-frame tool rotation for a down-pointing pusher whose board or
    stick axis is yawed by `pusher_angle` about the vertical (the env's
    orn = [0, pi, angle + pi/2] euler, flex_env.py:276). Returns a
    (..., 3, 3) float32 rotation whose local +z points DOWN (-y world), so
    a tool offset of [0, 0, L] in the link frame lands L units below the
    eef (the convention of the preprocessing eef offsets)."""
    a = torch.as_tensor(pusher_angle, dtype=torch.float32) + np.float32(np.pi / 2)
    ca, sa = torch.cos(a), torch.sin(a)
    # columns: local x, y, z expressed in world (flex) coords
    x_axis = torch.stack([ca, torch.zeros_like(a), -sa], -1)
    z_axis = torch.tensor([0.0, -1.0, 0.0], device=a.device).expand(
        x_axis.shape)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    return torch.stack([x_axis, y_axis, z_axis], dim=-1)
