"""Kinematic-shape collision: signed distances, normals, contact projection.

Counterpart of adaptigraph_tpu/engine/collisions.py. Shapes are boxes,
capsules, an infinite floor plane and convex polytopes. The JAX version
vmaps one shape over the particles; here the shape axis is a leading batch
dimension of (M, N, ...) tensors, with the same branch-free math.
"""

from __future__ import annotations

import torch

from adaptigraph_torch.engine.state import (
    SHAPE_BOX, SHAPE_CAPSULE, SHAPE_CONVEX, ShapeSet)
from adaptigraph_torch.utils import geometry as geo

_EPS = 1e-9


def _norm(x, keepdim: bool = False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _box_sdf(q, half):
    """SDF + outward normal of an axis-aligned box at origin, local point q."""
    d = torch.abs(q) - half
    outside = torch.clamp(d, min=0.0)
    dist_out = _norm(outside)
    max_d = torch.amax(d, dim=-1)
    sd = dist_out + torch.clamp(max_d, max=0.0)
    # outside: gradient of |max(d,0)|; inside: face of least penetration
    n_out = outside * torch.sign(q)
    n_out = n_out / (_norm(n_out, keepdim=True) + _EPS)
    inner_axis = torch.argmax(d, dim=-1)  # first maximum on ties, like JAX
    n_in = torch.nn.functional.one_hot(inner_axis, 3).to(q.dtype) * torch.sign(q)
    n = torch.where((max_d > 0.0)[..., None], n_out, n_in)
    return sd, n


def _capsule_sdf(q, size):
    """Capsule along local +x: size = (radius, half_length, _)."""
    r, hl = size[..., 0], size[..., 1]
    a = torch.clamp(q[..., 0], min=-hl, max=hl)
    zero = torch.zeros_like(a)
    d = q - torch.stack([a, zero, zero], dim=-1)
    dist = _norm(d)
    return dist - r, d / (dist[..., None] + _EPS)


def _plane_sdf(q):
    n = torch.zeros_like(q)
    n[..., 1] = 1.0
    return q[..., 1], n


def _convex_sdf(q, planes):
    """Convex polytope as the intersection of halfspaces n.x <= d.

    q: (M, N, 3); planes: (M, P, 4) local halfspaces, zero-normal rows =
    padding."""
    n = planes[..., :3]  # (M, P, 3)
    d = planes[..., 3]  # (M, P)
    pvalid = torch.sum(n * n, dim=-1) > 0.25
    sd_p = torch.einsum("mki,mpi->mkp", q, n) - d[:, None, :]
    sd_p = torch.where(pvalid[:, None, :], sd_p, torch.full_like(sd_p, -3e37))
    sd, best = torch.max(sd_p, dim=-1)  # first maximum on ties
    sd = torch.where(torch.any(pvalid, dim=-1)[:, None], sd,
                     torch.full_like(sd, 3e37))
    nrm = torch.gather(n, 1, best[..., None].expand(best.shape + (3,)))
    return sd, nrm


def shape_sdf(p_world, kind, size, pos, quat, planes=None):
    """Signed distance + world-frame outward normal of M shapes for a batch
    of world points. p_world (N, 3); kind (M,); size/pos (M, 3); quat
    (M, 4); planes (M, P, 4) or None. Returns sd (M, N), n (M, N, 3)."""
    kind = kind[:, None]
    q = geo.quat_rotate(geo.quat_conjugate(quat)[:, None, :],
                        p_world[None] - pos[:, None, :])
    sd_box, n_box = _box_sdf(q, size[:, None, :])
    sd_cap, n_cap = _capsule_sdf(q, size[:, None, :])
    sd_pl, n_pl = _plane_sdf(q)
    is_box, is_cap = kind == SHAPE_BOX, kind == SHAPE_CAPSULE
    sd = torch.where(is_box, sd_box, torch.where(is_cap, sd_cap, sd_pl))
    n_local = torch.where(is_box[..., None], n_box,
                          torch.where(is_cap[..., None], n_cap, n_pl))
    if planes is not None and planes.shape[-2] > 0:
        sd_cx, n_cx = _convex_sdf(q, planes)
        is_cx = kind == SHAPE_CONVEX
        sd = torch.where(is_cx, sd_cx, sd)
        n_local = torch.where(is_cx[..., None], n_cx, n_local)
    n_world = geo.quat_rotate(quat[:, None, :], n_local)
    return sd, n_world


def shape_contact_deltas(pos_pred, pos_prev, shapes: ShapeSet, shape_pos,
                         shape_quat, shape_vel, collision_distance, margin,
                         dynamic_friction, dt):
    """Position corrections for particle-vs-kinematic-shape contacts.

    pos_pred / pos_prev: (N, 3) predicted and substep-start positions;
    shape_pos / shape_quat / shape_vel: (M, 3) / (M, 4) / (M, 3) poses and
    velocities at this substep. `margin` is accepted for signature parity
    with the JAX pass, which does not use it either. Returns (delta (N, 3),
    count (N,)): summed corrections and active contacts per particle.
    `shape_contact_deltas.calls` counts the calls (the fused stage, K4,
    replaces them)."""
    shape_contact_deltas.calls += 1
    sd, n = shape_sdf(pos_pred, shapes.kind, shapes.size, shape_pos,
                      shape_quat, planes=shapes.planes)
    pen = collision_distance - sd  # (M, N); > 0 inside the collision offset
    in_contact = (pen > 0.0) & shapes.valid[:, None]
    delta_n = n * pen[..., None]
    # Coulomb friction on the tangential relative displacement this substep
    rel = (pos_pred - pos_prev)[None] - shape_vel[:, None, :] * dt
    rel_t = rel - n * torch.sum(rel * n, dim=-1, keepdim=True)
    rel_t_norm = _norm(rel_t, keepdim=True)
    max_slide = dynamic_friction * torch.abs(pen)[..., None]
    scale = torch.clamp(max_slide / (rel_t_norm + _EPS), max=1.0)
    delta = torch.where(in_contact[..., None], delta_n - rel_t * scale,
                        torch.zeros_like(delta_n))
    return torch.sum(delta, dim=0), torch.sum(in_contact.to(pos_pred.dtype), dim=0)


shape_contact_deltas.calls = 0
