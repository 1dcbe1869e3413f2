"""Engine state containers: NamedTuples of fixed-shape tensors.

Counterpart of adaptigraph_tpu/engine/state.py. The containers keep the
JAX package's field names, shapes and dtypes (particles carry an `active`
mask, springs / clusters / shapes carry `valid` masks), so a scene built by
either package converts to the other field by field (`scene_from_numpy`).
The host-side builders are numpy and put their result on `device` once at
the end.

Conventions: y-up, dt = 1/60 s per outer step, quaternions xyzw.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SHAPE_BOX = 0
SHAPE_CAPSULE = 1
SHAPE_PLANE = 2  # infinite plane with normal +y at pos.y (floor)
SHAPE_CONVEX = 3  # convex polytope: intersection of local halfspaces


class ParticleState(NamedTuple):
    pos: torch.Tensor  # (N, 3) f32
    vel: torch.Tensor  # (N, 3) f32
    inv_mass: torch.Tensor  # (N,) f32; 0 = pinned
    group: torch.Tensor  # (N,) int32 collision group
    self_collide: torch.Tensor  # (N,) bool
    active: torch.Tensor  # (N,) bool


class SpringSet(NamedTuple):
    """Distance constraints; idx pairs into particles."""

    idx: torch.Tensor  # (S, 2) int32
    rest: torch.Tensor  # (S,) f32
    stiffness: torch.Tensor  # (S,) f32
    valid: torch.Tensor  # (S,) bool


class ClusterSet(NamedTuple):
    """Shape-matching clusters: possibly overlapping particle groups pulled
    toward a rigidly transformed rest shape."""

    member: torch.Tensor  # (C, K) int32 particle indices (0-padded)
    member_valid: torch.Tensor  # (C, K) bool
    rest: torch.Tensor  # (C, K, 3) f32 rest offsets from cluster COM
    stiffness: torch.Tensor  # (C,) f32
    valid: torch.Tensor  # (C,) bool


class ClusterIncidence(NamedTuple):
    """Per-particle incident (cluster, slot) table into the flattened
    (C*K,) member axis."""

    idx: torch.Tensor  # (N, D) int32
    valid: torch.Tensor  # (N, D) bool


class ClusterMatmul(NamedTuple):
    """Membership-matrix form of the shape-matching cluster pass (see the
    JAX ClusterMatmul for the algebra): segment reductions become two matrix
    products with the 0/1 membership matrix M (C, N)."""

    matrix: torch.Tensor  # (C, N) f32 0/1 membership
    com0: torch.Tensor  # (C, 3) member-mean rest COM
    com0_goal: torch.Tensor  # (C, 3) goal reference point
    count: torch.Tensor  # (C,) f32 member counts
    a00: torch.Tensor  # (C, 9) static rest covariance (f64-accumulated)


class ClusterSegments(NamedTuple):
    """Contiguous-segment form of the cluster pass, for scenes whose
    clusters are disjoint contiguous index ranges in build order (granular:
    particles are appended granule by granule). Segment reductions become
    a cumsum and a (C+1)-row boundary gather, and the broadcast back an
    (N,)-row gather of a small (C+1, 14) table."""

    starts: torch.Tensor  # (C+1,) int32 cumulative boundaries
    cid: torch.Tensor  # (N,) int32 cluster id per particle, C = "none"
    com0: torch.Tensor  # (C, 3) rest COM per cluster
    count: torch.Tensor  # (C,) f32 member counts (>= 1)
    a00: torch.Tensor  # (C, 9) static rest covariance (f64-accumulated)


class ShapeSet(NamedTuple):
    """Kinematic collision shapes (table, pusher, floor)."""

    kind: torch.Tensor  # (M,) int32 in {BOX, CAPSULE, PLANE, CONVEX}
    size: torch.Tensor  # (M, 3) box half-edges / capsule (radius, half_len, _)
    pos: torch.Tensor  # (M, 3)
    quat: torch.Tensor  # (M, 4) xyzw
    prev_pos: torch.Tensor  # (M, 3)
    prev_quat: torch.Tensor  # (M, 4)
    valid: torch.Tensor  # (M,) bool
    planes: torch.Tensor  # (M, P, 4) convex-hull halfspaces (P may be 0)

    def moved_to(self, pos, quat) -> "ShapeSet":
        """New pose; the old current pose becomes prev (one sim frame)."""
        return self._replace(prev_pos=self.pos, prev_quat=self.quat, pos=pos,
                             quat=quat)


class SolverParams(NamedTuple):
    """Per-scene solver parameters, each a 0-d float32 tensor (build them
    with `make_params`) so the solver's scalar arithmetic rounds in float32
    as the JAX solver's does."""

    dt: torch.Tensor
    gravity: torch.Tensor
    radius: torch.Tensor
    solid_rest_distance: torch.Tensor
    collision_distance: torch.Tensor
    shape_collision_margin: torch.Tensor
    dynamic_friction: torch.Tensor
    particle_friction: torch.Tensor
    static_friction: torch.Tensor
    damping: torch.Tensor
    dissipation: torch.Tensor
    sleep_threshold: torch.Tensor
    relaxation_factor: torch.Tensor
    max_speed: torch.Tensor
    restitution: torch.Tensor
    collide_filter_dist: torch.Tensor
    plastic_threshold: torch.Tensor
    plastic_creep: torch.Tensor


_PARAM_DEFAULTS = dict(
    dt=1.0 / 60.0, gravity=-9.8, radius=0.03, solid_rest_distance=0.03,
    collision_distance=0.015, shape_collision_margin=0.0,
    dynamic_friction=0.1, particle_friction=0.25, static_friction=0.0,
    damping=0.0, dissipation=0.0, sleep_threshold=0.0, relaxation_factor=1.0,
    max_speed=1e6, restitution=0.0, collide_filter_dist=0.0,
    plastic_threshold=0.0, plastic_creep=0.0)


def make_params(device, **overrides) -> SolverParams:
    """SolverParams with the JAX package's defaults, overridden by keyword."""
    unknown = set(overrides) - set(_PARAM_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown solver parameters {sorted(unknown)}")
    vals = {**_PARAM_DEFAULTS, **overrides}
    return SolverParams(**{k: torch.tensor(float(np.float32(v)),
                                           dtype=torch.float32, device=device)
                           for k, v in vals.items()})


class SceneSpec(NamedTuple):
    """Static scene description (constraint topology + solver params)."""

    springs: SpringSet
    clusters: ClusterSet
    global_stiffness: torch.Tensor  # 0-d f32
    # (N, 3) global-cluster rest offsets, or (0, 3) for "no global cluster"
    global_rest: torch.Tensor
    rest_pos: torch.Tensor  # (N, 3)
    params: SolverParams
    cluster_inc: ClusterIncidence | None = None
    cluster_mm: ClusterMatmul | None = None
    cluster_seg: ClusterSegments | None = None


class SceneState(NamedTuple):
    """Evolving state threaded through `xpbd_step`."""

    particles: ParticleState
    shapes: ShapeSet
    cluster_rot: torch.Tensor  # (C, 4)
    global_rot: torch.Tensor  # (4,)
    cluster_rest: torch.Tensor | None = None
    # running count of AABB-overlapping tile pairs dropped by the block
    # contact sweep's per-row cap; nonzero means contacts were skipped
    contact_overflow: torch.Tensor | int = 0


def tree_to(obj, device):
    """Move every tensor of a container (nested NamedTuples) to `device`."""
    if obj is None:
        return None
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_to(v, device) for v in obj))
    return obj


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)


def make_particles(pos, inv_mass=None, group=None, self_collide=False,
                   n_max=None, device="cpu") -> ParticleState:
    """Padded ParticleState from an (n, 3) position array."""
    pos = np.asarray(pos, dtype=np.float32)
    n = pos.shape[0]
    n_max = n_max or n
    if inv_mass is None:
        inv_mass = np.ones((n,), dtype=np.float32)
    else:
        inv_mass = np.broadcast_to(np.asarray(inv_mass, np.float32), (n,)).copy()
    if group is None:
        group = np.zeros((n,), dtype=np.int32)
    else:
        group = np.broadcast_to(np.asarray(group, np.int32), (n,)).copy()
    sc = np.broadcast_to(np.asarray(self_collide, dtype=bool), (n,)).copy()

    def pad(a, fill=0):
        out = np.full((n_max,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n] = a
        return out

    return ParticleState(
        pos=_t(pad(pos), device),
        vel=torch.zeros((n_max, 3), dtype=torch.float32, device=device),
        inv_mass=_t(pad(inv_mass), device),
        group=_t(pad(group, fill=-1), device),
        self_collide=_t(pad(sc, fill=False), device),
        active=_t(pad(np.ones(n, dtype=bool), fill=False), device),
    )


def empty_springs(capacity: int, device="cpu") -> SpringSet:
    return SpringSet(
        idx=torch.zeros((capacity, 2), dtype=torch.int32, device=device),
        rest=torch.zeros((capacity,), dtype=torch.float32, device=device),
        stiffness=torch.zeros((capacity,), dtype=torch.float32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def make_clusters(members: list, positions, stiffness, c_max=None, k_max=None,
                  device="cpu") -> ClusterSet:
    """members: list of index lists; rest offsets are computed from
    `positions` relative to each cluster's (uniform-mass) COM."""
    positions = np.asarray(positions, dtype=np.float32)
    c = len(members)
    c_max = c_max or max(c, 1)
    k_max = k_max or max((len(m) for m in members), default=1)
    member = np.zeros((c_max, k_max), dtype=np.int32)
    mvalid = np.zeros((c_max, k_max), dtype=bool)
    rest = np.zeros((c_max, k_max, 3), dtype=np.float32)
    stiff = np.zeros((c_max,), dtype=np.float32)
    cvalid = np.zeros((c_max,), dtype=bool)
    stiffness = np.broadcast_to(np.asarray(stiffness, dtype=np.float32), (c,))
    for ci, m in enumerate(members):
        m = np.asarray(m, dtype=np.int32)
        k = len(m)
        if k > k_max:
            raise ValueError(f"cluster {ci} has {k} members > k_max={k_max}")
        member[ci, :k] = m
        mvalid[ci, :k] = True
        com = positions[m].mean(axis=0)
        rest[ci, :k] = positions[m] - com
        stiff[ci] = stiffness[ci]
        cvalid[ci] = True
    return ClusterSet(member=_t(member, device), member_valid=_t(mvalid, device),
                      rest=_t(rest, device), stiffness=_t(stiff, device),
                      valid=_t(cvalid, device))


def make_shapes(kinds, sizes, poses, quats, m_max=None, planes=None, p_max=0,
                device="cpu") -> ShapeSet:
    """planes: optional list (len m) of (p_i, 4) local halfspaces for CONVEX
    shapes (None entries allowed); padded to (m_max, p_max, 4)."""
    kinds = np.asarray(kinds, dtype=np.int32).reshape(-1)
    m = kinds.shape[0]
    m_max = m_max or m
    sizes = np.asarray(sizes, dtype=np.float32).reshape(m, 3)
    poses = np.asarray(poses, dtype=np.float32).reshape(m, 3)
    quats = np.asarray(quats, dtype=np.float32).reshape(m, 4)
    if planes is not None:
        p_max = max(p_max, max((0 if p is None else len(p)) for p in planes))
    planes_p = np.zeros((m_max, p_max, 4), dtype=np.float32)
    if planes is not None:
        for i, p in enumerate(planes):
            if p is not None and len(p):
                planes_p[i, : len(p)] = np.asarray(p, dtype=np.float32)

    def pad(a, fill=0.0):
        out = np.full((m_max,) + a.shape[1:], fill, dtype=a.dtype)
        out[:m] = a
        return out

    qpad = pad(quats)
    qpad[m:, 3] = 1.0
    return ShapeSet(
        kind=_t(pad(kinds), device), size=_t(pad(sizes), device),
        pos=_t(pad(poses), device), quat=_t(qpad, device),
        prev_pos=_t(pad(poses), device), prev_quat=_t(qpad, device),
        valid=_t(pad(np.ones(m, dtype=bool), fill=False), device),
        planes=_t(planes_p, device))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def build_cluster_incidence(clusters: ClusterSet, n: int,
                            d_max: int | None = None) -> ClusterIncidence:
    """Host-side transpose of cluster membership (numpy)."""
    device = clusters.member.device
    member = _np(clusters.member)
    mvalid = _np(clusters.member_valid) & _np(clusters.valid)[:, None]
    c, k = member.shape
    flat = member.reshape(-1)
    fvalid = mvalid.reshape(-1)
    slot = np.arange(c * k)
    flat, slot = flat[fvalid], slot[fvalid]
    deg = np.bincount(flat, minlength=n) if len(flat) else np.zeros(n, np.int64)
    d = int(d_max if d_max is not None else max(int(deg.max(initial=0)), 1))
    inc_idx = np.zeros((n, d), dtype=np.int32)
    inc_valid = np.zeros((n, d), dtype=bool)
    order = np.argsort(flat, kind="stable")
    fs = flat[order]
    first = np.searchsorted(fs, fs, side="left")
    rank = np.arange(len(fs)) - first
    ok = rank < d
    inc_idx[fs[ok], rank[ok]] = slot[order][ok]
    inc_valid[fs[ok], rank[ok]] = True
    if not ok.all() and d_max is None:
        raise ValueError("cluster incidence overflow")
    return ClusterIncidence(idx=_t(inc_idx, device), valid=_t(inc_valid, device))


def build_cluster_matmul(clusters: ClusterSet, rest_pos,
                         n: int) -> ClusterMatmul | None:
    """Host-side membership matrix; None when the rest offsets are not
    consistent with rest_pos (the factorization would be wrong)."""
    device = clusters.member.device
    member = _np(clusters.member)
    mvalid = _np(clusters.member_valid) & _np(clusters.valid)[:, None]
    rest = _np(clusters.rest)
    rest_pos = _np(rest_pos)[:n]
    c = member.shape[0]
    mat = np.zeros((c, n), dtype=np.float32)
    com0 = np.zeros((c, 3), dtype=np.float32)
    cnt = np.ones((c,), dtype=np.float32)
    a00 = np.zeros((c, 9), dtype=np.float32)
    rest64 = rest_pos.astype(np.float64)
    for ci in range(c):
        m = member[ci][mvalid[ci]]
        if len(m) == 0:
            continue
        mat[ci, m] = 1.0
        co64 = rest64[m].mean(axis=0)
        com0[ci] = co64.astype(np.float32)
        cnt[ci] = float(len(m))
        cen = rest64[m] - co64
        a00[ci] = np.einsum("ki,kj->ij", cen, cen).reshape(9).astype(np.float32)
        if not np.allclose(cen.astype(np.float32), rest[ci][mvalid[ci]],
                           atol=1e-4):
            return None
    return ClusterMatmul(matrix=_t(mat, device), com0=_t(com0, device),
                         com0_goal=_t(com0, device), count=_t(cnt, device),
                         a00=_t(a00, device))


def build_cluster_segments(clusters: ClusterSet, rest_pos,
                           n: int) -> ClusterSegments | None:
    """Host-side detection and table build. None unless the valid clusters
    are a compact prefix of the rows, each a contiguous ascending range,
    the ranges disjoint and in order, and the rest offsets consistent with
    rest_pos (the rule of build_cluster_matmul)."""
    device = clusters.member.device
    member = _np(clusters.member)
    mvalid = _np(clusters.member_valid) & _np(clusters.valid)[:, None]
    rest = _np(clusters.rest)
    rest_pos = _np(rest_pos)[:n]
    c_rows = member.shape[0]
    starts, com0, cnt, a00 = [], [], [], []
    cid = np.full((n,), 0, dtype=np.int32)
    rest64 = rest_pos.astype(np.float64)
    cursor = 0
    n_valid = 0
    for ci in range(c_rows):
        m = member[ci][mvalid[ci]]
        if len(m) == 0:
            continue
        if ci != n_valid:  # valid clusters must be a compact prefix
            return None
        if not (m[0] == cursor
                and np.array_equal(m, np.arange(m[0], m[0] + len(m)))):
            return None
        co64 = rest64[m].mean(axis=0)
        if not np.allclose(rest_pos[m] - co64.astype(np.float32),
                           rest[ci][mvalid[ci]], atol=1e-4):
            return None
        cen = rest64[m] - co64
        a00.append(np.einsum("ki,kj->ij", cen, cen).reshape(9)
                   .astype(np.float32))
        starts.append(cursor)
        com0.append(co64)
        cnt.append(float(len(m)))
        cid[m] = n_valid
        n_valid += 1
        cursor += len(m)
    if n_valid == 0:
        return None
    # pad the per-cluster tables to the cap
    starts = starts + [cursor] * (c_rows - n_valid + 1)
    com0 = com0 + [np.zeros(3, np.float64)] * (c_rows - n_valid)
    cnt = cnt + [1.0] * (c_rows - n_valid)
    a00 = a00 + [np.zeros(9, np.float32)] * (c_rows - n_valid)
    cid[cursor:] = c_rows  # padding particles -> the "none" row
    return ClusterSegments(
        starts=_t(np.asarray(starts, np.int32), device),
        cid=_t(cid, device),
        com0=_t(np.stack(com0).astype(np.float32), device),
        count=_t(np.asarray(cnt, np.float32), device),
        a00=_t(np.stack(a00), device))


def fold_global_cluster(spec: SceneSpec, particles: ParticleState) -> SceneSpec:
    """Fold the global shape-matching cluster into a free padding row of the
    membership-matrix cluster pass (exact while inv_mass is static, which
    holds for rope). No-op without a global cluster, a matmul pass, a
    positive stiffness or a free row."""
    if spec.global_rest.shape[0] == 0 or spec.cluster_mm is None:
        return spec
    if float(spec.global_stiffness) <= 0.0:
        return spec
    cl = spec.clusters
    device = cl.valid.device
    valid = _np(cl.valid)
    free = np.nonzero(~valid)[0]
    if len(free) == 0:
        return spec
    row = int(free[0])
    inv_mass = _np(particles.inv_mass)
    active = _np(particles.active)
    mm = spec.cluster_mm
    n = mm.matrix.shape[1]
    mask = (active[:n] & (inv_mass[:n] > 0)).astype(np.float32)
    cnt = max(float(mask.sum()), 1.0)
    rest_pos = _np(spec.rest_pos)[:n].astype(np.float64)
    com0_memb = (rest_pos * mask[:, None]).sum(0) / cnt
    sel = active[:n]
    c0 = (rest_pos[sel] - _np(spec.global_rest)[:n][sel]).mean(0)
    mat = _np(mm.matrix).copy()
    com0 = _np(mm.com0).copy()
    com0_goal = _np(mm.com0_goal).copy()
    count = _np(mm.count).copy()
    a00 = _np(mm.a00).copy()
    mat[row] = mask
    com0[row] = com0_memb.astype(np.float32)
    com0_goal[row] = c0.astype(np.float32)
    count[row] = cnt
    cen = (rest_pos - com0_memb) * mask[:, None]
    a00[row] = np.einsum("ki,kj->ij", cen, cen).reshape(9).astype(np.float32)
    stiff = _np(cl.stiffness).copy()
    cvalid = valid.copy()
    stiff[row] = float(spec.global_stiffness)
    cvalid[row] = True
    return spec._replace(
        clusters=cl._replace(stiffness=_t(stiff, device),
                             valid=_t(cvalid, device)),
        cluster_mm=ClusterMatmul(matrix=_t(mat, device), com0=_t(com0, device),
                                 com0_goal=_t(com0_goal, device),
                                 count=_t(count, device), a00=_t(a00, device)),
        global_rest=torch.zeros((0, 3), dtype=torch.float32, device=device),
    )


def trim_cluster_matmul(spec: SceneSpec) -> SceneSpec:
    """Cut the membership matrix to its valid-row prefix, rounded up to a
    multiple of 8 (the padding rows are all zero). Per-cluster state keeps
    its cap-C shape; the solver slices the prefix. Run after
    `fold_global_cluster`, which claims the first free row."""
    mm = spec.cluster_mm
    if mm is None:
        return spec
    c = mm.matrix.shape[0]
    valid = _np(spec.clusters.valid)[:c]
    nz = _np(mm.matrix).any(axis=1)
    used = valid | nz
    nv = int(np.nonzero(used)[0].max()) + 1 if used.any() else 1
    ct = min(c, -(-nv // 8) * 8)
    if ct >= c or nz[ct:].any():
        return spec
    return spec._replace(cluster_mm=ClusterMatmul(*(t[:ct].contiguous()
                                                    for t in mm)))


# --- the state carried across from the JAX package -------------------------

def tree_to_numpy(obj):
    """A container flattened by field name: each NamedTuple becomes a dict
    of its fields, each array leaf (torch tensor, or any array numpy can
    read, such as a JAX array) a numpy array; None stays None. The inverse
    of `scene_from_numpy` for either package's scenes."""
    if obj is None:
        return None
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: tree_to_numpy(v) for k, v in obj._asdict().items()}
    return _np(obj)


_SPEC_FIELDS_NOT_PORTED = ("spring_inc", "offset_springs")


def _leaf(a, device):
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return _t(a, device)


def _named(cls, d: dict, device):
    return cls(**{k: (None if d[k] is None else _leaf(d[k], device))
                  for k in cls._fields if k in d})


def scene_from_numpy(state: dict, spec: dict, device=None):
    """(SceneState, SceneSpec) on `device` from a JAX scene flattened by
    field name to numpy arrays: each NamedTuple becomes a dict of its
    fields, each leaf a numpy array (or None). Spec parts the port does
    not cover yet (spring incidence, offset springs) raise
    NotImplementedError when present."""
    from adaptigraph_torch.utils.device import resolve_device

    device = resolve_device(device)
    for k in _SPEC_FIELDS_NOT_PORTED:
        if spec.get(k) is not None:
            raise NotImplementedError(
                f"spec.{k} is not ported yet (ROADMAP Queue 1 item 6)")
    params = make_params(device, **{k: float(np.asarray(v))
                                    for k, v in spec["params"].items()})
    out_spec = SceneSpec(
        springs=_named(SpringSet, spec["springs"], device),
        clusters=_named(ClusterSet, spec["clusters"], device),
        global_stiffness=_leaf(spec["global_stiffness"], device),
        global_rest=_leaf(spec["global_rest"], device),
        rest_pos=_leaf(spec["rest_pos"], device),
        params=params,
        cluster_inc=(None if spec.get("cluster_inc") is None else
                     _named(ClusterIncidence, spec["cluster_inc"], device)),
        cluster_mm=(None if spec.get("cluster_mm") is None else
                    _named(ClusterMatmul, spec["cluster_mm"], device)),
        cluster_seg=(None if spec.get("cluster_seg") is None else
                     _named(ClusterSegments, spec["cluster_seg"], device)),
    )
    out_state = SceneState(
        particles=_named(ParticleState, state["particles"], device),
        shapes=_named(ShapeSet, state["shapes"], device),
        cluster_rot=_leaf(state["cluster_rot"], device),
        global_rot=_leaf(state["global_rot"], device),
        cluster_rest=(None if state.get("cluster_rest") is None
                      else _leaf(state["cluster_rest"], device)),
        contact_overflow=_t(np.int32(np.asarray(
            state.get("contact_overflow", 0))), device),
    )
    return out_state, out_spec
