"""XPBD particle solver: the simulator frame, ported from
adaptigraph_tpu/engine/solver.py.

Per substep: integrate -> `iterations` x Jacobi projection of {particle
contacts + friction, kinematic-shape contacts + friction, shape-matching
clusters, global cluster} -> velocity update (dissipation, sleeping).

The port covers the passes the rope and granular scenes run. Particle
contacts use the `block` mode, the AABB-culled tile sweep of
contact_kernels (K1) over block lists built once per frame and refined by
K2, or the `dense` mode, the all-pairs sweep (K3). With `n_shapes_active`
set, block mode fuses the kinematic-shape pass into K1 (K4). Substeps and
iterations are Python loops (the JAX version's lax.scan / fori_loop). The
cluster pass runs as two float32 matrix products with TF32 off (the
membership-matrix form, rope) or as a cumsum over contiguous segments
(granular): lossy matmul precision washes out friction (the JAX solver
runs its products at Precision.HIGHEST for the same reason).

Not ported yet, and raising NotImplementedError rather than substituting
another path: the `sparse` contact mode, distance springs, the gather
cluster pass, and plastic flow.
"""

from __future__ import annotations

import torch

from adaptigraph_torch.engine.collisions import shape_contact_deltas
from adaptigraph_torch.engine.contact_kernels import (
    TILE, block_sparse_contact_deltas_packed, dense_contact_deltas_packed,
    pack_contact_tables, refine_overlap_blocks_packed, tile_overlap_blocks,
    update_contact_tables)
from adaptigraph_torch.engine.state import (
    ParticleState, SceneSpec, SceneState, ShapeSet)
from adaptigraph_torch.utils import geometry as geo

_EPS = 1e-9
_F32 = torch.float32


def auto_contact_mode(n: int) -> str:
    """Contact-sweep implementation for an `n`-particle scene (the JAX
    package's rule): the dense sweep up to 2,048 particles, the
    AABB-culled block sweep above."""
    return "dense" if n <= 2048 else "block"


def auto_tile_j(n: int) -> int:
    """Contact-sweep column-tile width for an `n`-row scene."""
    return 256 if n > 16384 else TILE


def _contact_mode(mode: str | None, n: int) -> str:
    """The contact mode a frame runs: `mode`, or auto_contact_mode(n)."""
    mode = mode or auto_contact_mode(n)
    if mode == "sparse":
        raise NotImplementedError(
            "contact_mode='sparse' waits for ROADMAP Queue 1 item 15")
    if mode not in ("block", "dense"):
        raise ValueError(f"unknown contact_mode {mode!r}")
    return mode


def pack_tables_for(particles: ParticleState, spec: SceneSpec,
                    tile_j: int | None = None):
    """The frame-constant contact tables of `particles` for the block
    sweep, at `tile_j` columns (None: auto_tile_j). The one block-table
    packing rule that xpbd_step, rollout_steps and the smoke share (the
    dense sweep packs its own tables once per substep)."""
    return pack_contact_tables(
        particles.pos, particles.pos, particles.group, particles.inv_mass,
        particles.self_collide, particles.active, spec.rest_pos,
        tile_j=tile_j or auto_tile_j(particles.pos.shape[0]))


def _pad_tile(x, t: int = TILE):
    pad = (-x.shape[0]) % t
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)


def _full_f32_matmul():
    """Keep float32 matrix products in full float32 on the GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mat3_apply(m3, v):
    """(..., 3, 3) @ (..., 3) as explicit multiply-adds."""
    return torch.stack(
        [m3[..., 0, 0] * v[..., 0] + m3[..., 0, 1] * v[..., 1] + m3[..., 0, 2] * v[..., 2],
         m3[..., 1, 0] * v[..., 0] + m3[..., 1, 1] * v[..., 1] + m3[..., 1, 2] * v[..., 2],
         m3[..., 2, 0] * v[..., 0] + m3[..., 2, 1] * v[..., 1] + m3[..., 2, 2] * v[..., 2]],
        dim=-1)


def _cluster_deltas_matmul(pos, pos0, clusters, cluster_rot, mm):
    """Shape-matching corrections through the membership matrix
    (state.ClusterMatmul): segment reductions as two matrix products, in
    displacement form (u = pos - pos0) to limit cancellation. The matrix
    may be trimmed to its valid-row prefix; the per-cluster state keeps
    its cap, and the untouched tail is stitched back on return."""
    m = mm.matrix  # (C_t, N)
    ct = m.shape[0]
    rot_tail = cluster_rot[ct:]
    cluster_rot = cluster_rot[:ct]
    cl_valid = clusters.valid[:ct]
    cl_stiff = clusters.stiffness[:ct]
    cnt = torch.clamp(mm.count, min=1.0)[:, None]  # (C_t, 1)
    u = pos - pos0
    outer = (u[:, :, None] * pos0[:, None, :]).reshape(-1, 9)
    uo = torch.cat([u, outer], dim=1)  # (N, 12)
    g12 = torch.matmul(m, uo)  # (C_t, 12)
    ubar = g12[:, :3] / cnt
    com = mm.com0 + ubar
    a = (mm.a00.reshape(-1, 3, 3) + g12[:, 3:].reshape(-1, 3, 3)
         - cnt[..., None] * (ubar[:, :, None] * mm.com0[:, None, :]))
    q_new = geo.extract_rotation(a, cluster_rot, iterations=6)
    q_new = torch.where(cl_valid[:, None], q_new, cluster_rot)
    r = geo.quat_to_matrix(q_new)
    s = cl_stiff
    b = s[:, None] * (com - _mat3_apply(r, mm.com0_goal))
    packed = torch.cat(
        [b, (s[:, None, None] * r).reshape(-1, 9), s[:, None],
         cl_valid.to(pos.dtype)[:, None]], dim=1)  # (C_t, 14)
    g = torch.matmul(m.T, packed)  # (N, 14)
    delta = (g[:, :3] + _mat3_apply(g[:, 3:12].reshape(-1, 3, 3), pos0)
             - g[:, 12:13] * pos)
    return delta, g[:, 13], torch.cat([q_new, rot_tail], dim=0)


def _cluster_deltas_segments(pos, pos0, clusters, cluster_rot, seg):
    """Shape-matching corrections for disjoint contiguous clusters
    (state.ClusterSegments, the granular granule layout): one inclusive
    cumsum of an (N, 12) table, a boundary gather of (C+1) rows, and one
    (N, 14) table gather back to the particles. Same algebra as
    `_cluster_deltas_matmul`, in displacement form (u = pos - pos0); no
    matrix product, so TF32 plays no part."""
    n = pos.shape[0]
    cnt = torch.clamp(seg.count, min=1.0)[:, None]
    u = pos - pos0
    outer = (u[:, :, None] * pos0[:, None, :]).reshape(n, 9)
    uo = torch.cat([u, outer], dim=1)  # (N, 12)
    # the segment sums as differences of an inclusive cumsum at the
    # segment boundaries, both in float64: a float32 difference would carry
    # ~eps times the RUNNING sum (the JAX version's f32 cumsum does), and
    # torch's cumsum accumulates float32 in double on the CPU but in float
    # on CUDA, so float64 also keeps card and CPU on the same numbers. The
    # scan runs along the innermost dimension of the (12, N) transpose: a
    # cumsum along dim 0 of (N, 12) takes CUDA's outer-dimension scan,
    # which parallelises over the 12 columns only (5.7 ms a call at 32,768
    # rows, NVIDIA H100 80GB HBM3 at 700 W; PERF.md)
    cs = torch.cumsum(uo.T.to(torch.float64).contiguous(), dim=1)  # (12, N)
    cs = torch.cat([cs.new_zeros((12, 1)), cs], dim=1)
    bnd = cs[:, seg.starts.long()]  # (12, C+1)
    g12 = (bnd[:, 1:] - bnd[:, :-1]).T.to(pos.dtype)
    ubar = g12[:, :3] / cnt
    com = seg.com0 + ubar
    a = (seg.a00.reshape(-1, 3, 3) + g12[:, 3:].reshape(-1, 3, 3)
         - cnt[..., None] * (ubar[:, :, None] * seg.com0[:, None, :]))
    q_new = geo.extract_rotation(a, cluster_rot, iterations=6)
    q_new = torch.where(clusters.valid[:, None], q_new, cluster_rot)
    r = geo.quat_to_matrix(q_new)
    s = clusters.stiffness
    b = s[:, None] * (com - _mat3_apply(r, seg.com0))
    table = torch.cat(
        [b, (s[:, None, None] * r).reshape(-1, 9), s[:, None],
         clusters.valid.to(pos.dtype)[:, None]], dim=1)  # (C, 14)
    table = torch.cat([table, table.new_zeros((1, 14))], dim=0)
    g = table[seg.cid.long()]  # (N, 14)
    delta = (g[:, :3] + _mat3_apply(g[:, 3:12].reshape(-1, 3, 3), pos0)
             - g[:, 12:13] * pos)
    return delta, g[:, 13], q_new


def _global_cluster_deltas(pos, active, inv_mass, rest, stiffness, q_prev):
    """One shape-matching cluster spanning every movable active particle,
    for a scene whose global cluster was not folded into the matmul pass."""
    m = (active & (inv_mass > 0)).to(pos.dtype)[:, None]
    nmem = torch.clamp(torch.sum(m), min=1.0)
    com = torch.sum(pos * m, dim=0) / nmem
    centered = (pos - com) * m
    a = torch.matmul(centered.T, rest * m)
    q_new = geo.extract_rotation(a, q_prev, iterations=6)
    goal = com + geo.quat_rotate(q_new, rest)
    delta = (goal - pos) * stiffness * m
    cnt = (m[:, 0] > 0).to(pos.dtype) * (stiffness > 0).to(pos.dtype)
    return delta, cnt, q_new


def _nlerp(q0, q1, t):
    q1 = torch.where(torch.sum(q0 * q1, dim=-1, keepdim=True) < 0, -q1, q1)
    return geo.quat_normalize(q0 + (q1 - q0) * t)


def _shape_table(shapes: ShapeSet, s_pos, s_quat, s_vel, n_active: int):
    """The fused shape stage's inputs for this substep (the JAX _substep's
    packing): shp (A, 16) rows [kind, valid, size3, pos3, quat4, vel3, 0]
    of the first `n_active` shape slots, and their planes (A * P, 4), or
    None when the shapes carry no planes."""
    a = n_active
    f32 = s_pos.dtype
    shp = torch.cat([shapes.kind[:a, None].to(f32),
                     shapes.valid[:a, None].to(f32), shapes.size[:a],
                     s_pos[:a], s_quat[:a], s_vel[:a],
                     s_pos.new_zeros((a, 1))], dim=1)
    planes2d = (shapes.planes[:a].reshape(-1, 4).contiguous()
                if shapes.planes.shape[-2] > 0 else None)
    return shp, planes2d


def _substep(particles: ParticleState, cluster_rot, global_rot,
             spec: SceneSpec, shapes: ShapeSet, s_pos, s_quat, s_vel, dt,
             iterations: int, mode: str, blocks, tables, rest_filter: bool,
             tile_j: int, n_shapes_active: int | None):
    p = particles
    prm = spec.params
    mov = ((p.inv_mass > 0) & p.active).to(p.pos.dtype)[:, None]
    has_clusters = (spec.clusters.member.shape[0] > 0
                    and spec.clusters.member.shape[1] > 0)
    has_global = spec.global_rest.shape[0] > 0

    vel = p.vel.clone()
    vel[:, 1] += prm.gravity * dt
    vel = vel * torch.clamp(1.0 - prm.damping * dt, min=0.0)
    speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
    vel = vel * torch.clamp(prm.max_speed / (speed + _EPS), max=1.0)
    vel = vel * mov
    pos_prev = p.pos
    pos = pos_prev + vel * dt
    n = pos.shape[0]
    # the substep-start rows (friction reference) are fixed across the
    # iterations; refresh them once here (the dense sweep packs its tables
    # here, once per substep)
    if mode == "block":
        rows, cols = update_contact_tables(*tables, pos_prev,
                                           pos_prev=pos_prev)
        block_idx, block_cnt = blocks
    else:
        rows, cols = pack_contact_tables(
            pos_prev, pos_prev, p.group, p.inv_mass, p.self_collide,
            p.active, spec.rest_pos)
    fuse_shapes = mode == "block" and bool(n_shapes_active)
    shape_kw = {}
    if fuse_shapes:
        shp, planes2d = _shape_table(shapes, s_pos, s_quat, s_vel,
                                     n_shapes_active)
        shape_kw = dict(shp=shp, planes2d=planes2d, shape_params=(
            prm.collision_distance, prm.shape_collision_margin,
            prm.dynamic_friction, dt))

    for _ in range(iterations):
        update_contact_tables(rows, cols, pos)
        if mode == "block":
            delta, cnt = block_sparse_contact_deltas_packed(
                n, rows, cols, prm.solid_rest_distance,
                prm.particle_friction, prm.collide_filter_dist, block_idx,
                block_cnt, rest_filter=rest_filter, tile_j=tile_j, **shape_kw)
        else:
            delta, cnt = dense_contact_deltas_packed(
                n, rows, cols, prm.solid_rest_distance,
                prm.particle_friction, prm.collide_filter_dist)
        if not fuse_shapes:
            delta_k, cnt_k = shape_contact_deltas(
                pos, pos_prev, shapes, s_pos, s_quat, s_vel,
                prm.collision_distance, prm.shape_collision_margin,
                prm.dynamic_friction, dt)
            delta = delta + delta_k
            cnt = cnt + cnt_k
        if has_clusters:
            if spec.cluster_mm is not None:
                delta_m, cnt_m, cluster_rot = _cluster_deltas_matmul(
                    pos, spec.rest_pos, spec.clusters, cluster_rot,
                    spec.cluster_mm)
            else:
                delta_m, cnt_m, cluster_rot = _cluster_deltas_segments(
                    pos, spec.rest_pos, spec.clusters, cluster_rot,
                    spec.cluster_seg)
            delta = delta + delta_m
            cnt = cnt + cnt_m
        if has_global:
            delta_g, cnt_g, global_rot = _global_cluster_deltas(
                pos, p.active, p.inv_mass, spec.global_rest,
                spec.global_stiffness, global_rot)
            delta = delta + delta_g
            cnt = cnt + cnt_g
        pos = (pos + prm.relaxation_factor * delta
               / torch.clamp(cnt, min=1.0)[:, None] * mov)

    vel = (pos - pos_prev) / dt
    vel = vel * torch.clamp(1.0 - prm.dissipation * dt, min=0.0)
    # sleeping: freeze particles moving slower than the threshold
    slow = torch.linalg.vector_norm(vel, dim=-1, keepdim=True) < prm.sleep_threshold
    pos = torch.where(slow, pos_prev, pos)
    vel = torch.where(slow, torch.zeros_like(vel), vel)
    return p._replace(pos=pos, vel=vel), cluster_rot, global_rot


def _check_ported(state: SceneState, spec: SceneSpec):
    if spec.springs.idx.shape[0] > 0:
        raise NotImplementedError(
            "distance springs wait for ROADMAP Queue 1 item 6 (cloth)")
    has_clusters = (spec.clusters.member.shape[0] > 0
                    and spec.clusters.member.shape[1] > 0)
    if has_clusters and spec.cluster_mm is None and spec.cluster_seg is None:
        raise NotImplementedError(
            "only the membership-matrix and segment cluster passes are "
            "ported; the gather pass waits for ROADMAP Queue 1 item 6")
    if state.cluster_rest is not None:
        raise NotImplementedError(
            "plastic flow waits for ROADMAP Queue 1 item 6")


def frame_block_lists(particles: ParticleState, spec: SceneSpec, shape_vel,
                      tile_j: int):
    """The frame's AABB block lists and the keep distance K2 refines them
    at. Returns (block_idx, block_cnt, overflow, keep_dist).

    The AABB inflation radius * 1.5 covers a frame of drift; the list width
    follows the JAX solver's maxb rule. The keep distance is velocity
    adaptive: contact distance plus a margin for one frame of approach
    (fastest particle or shape), capped at the AABB inflation."""
    p0, prm = particles, spec.params
    n = p0.pos.shape[0]
    nb_j = (n + tile_j - 1) // tile_j
    maxb = min(nb_j, 128 if nb_j <= 128 else 64)
    block_idx, block_cnt, overflow = tile_overlap_blocks(
        _pad_tile(p0.pos, tile_j), _pad_tile(p0.active, tile_j),
        prm.radius * 1.5, max_blocks=maxb, tile_j=tile_j)
    vmax_p = torch.amax(torch.where(
        p0.active, torch.linalg.vector_norm(p0.vel, dim=-1),
        torch.zeros((), dtype=_F32, device=p0.pos.device)))
    vmax_s = torch.amax(torch.linalg.vector_norm(shape_vel, dim=-1))
    vmax = torch.maximum(vmax_p, vmax_s)
    keep_dist = torch.clamp(
        torch.maximum(prm.radius, prm.solid_rest_distance) * 1.02
        + 2.0 * vmax * prm.dt,
        min=prm.solid_rest_distance * 1.02,
        max=torch.maximum(prm.radius * 1.5, prm.solid_rest_distance * 1.05))
    return block_idx, block_cnt, overflow, keep_dist


def xpbd_step(state: SceneState, spec: SceneSpec, substeps: int,
              iterations: int, contact_mode: str | None = None,
              rest_filter: bool | None = None,
              contact_tile_j: int | None = None,
              n_shapes_active: int | None = None,
              packed_tables=None) -> SceneState:
    """One outer sim frame (dt = params.dt): kinematic shapes move from
    their prev pose to their current pose across the substeps; particles
    respond. Runs on the device the state's tensors lie on.

    contact_mode: 'block' (K1 over K2-refined block lists) or 'dense' (K3);
    None picks by size (auto_contact_mode). rest_filter: False when no
    particle self-collides (drops the rest-distance filter); None = True;
    the dense sweep always filters. n_shapes_active: in block mode, fuse
    the shape pass over the first that many shape slots into K1 (K4); the
    dense mode keeps the separate pass. packed_tables: block-mode tables
    from pack_tables_for whose 13 frame-constant rows are current (see
    rollout_steps); their position rows are overwritten in place.
    Sets torch.backends' TF32 switches off (full-float32 matmuls)."""
    _full_f32_matmul()
    _check_ported(state, spec)
    prm = spec.params
    dt_sub = prm.dt / substeps
    shapes = state.shapes
    s_vel = (shapes.pos - shapes.prev_pos) / prm.dt

    p0 = state.particles
    n = p0.pos.shape[0]
    dev = p0.pos.device
    mode = _contact_mode(contact_mode, n)
    rest_filter = True if rest_filter is None else rest_filter
    tj = contact_tile_j or auto_tile_j(n)
    tables = blocks = None
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if mode == "block":
        if packed_tables is not None:
            tables = update_contact_tables(*packed_tables, p0.pos,
                                           pos_prev=p0.pos)
        else:
            tables = pack_tables_for(p0, spec, tj)
        block_idx, block_cnt, overflow, keep_dist = frame_block_lists(
            p0, spec, s_vel, tj)
        blocks = refine_overlap_blocks_packed(
            n, *tables, keep_dist, prm.collide_filter_dist, block_idx,
            block_cnt, rest_filter=rest_filter, tile_j=tj)

    ts = (torch.arange(substeps, dtype=_F32, device=dev) + 1.0) / substeps
    particles, cl_rot, gl_rot = p0, state.cluster_rot, state.global_rot
    for k in range(substeps):
        t = ts[k]
        s_pos = shapes.prev_pos + (shapes.pos - shapes.prev_pos) * t
        s_quat = _nlerp(shapes.prev_quat, shapes.quat, t)
        particles, cl_rot, gl_rot = _substep(
            particles, cl_rot, gl_rot, spec, shapes, s_pos, s_quat, s_vel,
            dt_sub, iterations, mode, blocks, tables, rest_filter, tj,
            n_shapes_active)
    prior = torch.as_tensor(state.contact_overflow, dtype=torch.int32,
                            device=dev)
    return SceneState(particles=particles, shapes=shapes, cluster_rot=cl_rot,
                      global_rot=gl_rot, cluster_rest=None,
                      contact_overflow=prior + overflow)


def rollout_steps(state: SceneState, spec: SceneSpec, shape_pos_traj,
                  shape_quat_traj, substeps: int, iterations: int,
                  record: bool = True, contact_mode: str | None = None,
                  rest_filter: bool | None = None,
                  contact_tile_j: int | None = None,
                  n_shapes_active: int | None = None):
    """Run a whole tool trajectory: T outer frames.

    shape_pos_traj (T, M, 3), shape_quat_traj (T, M, 4): per-frame target
    poses of every kinematic shape (numpy or tensors). Returns
    (final_state, recorded positions (T, N, 3) if `record` else None).
    In block mode the contact tables are packed once for the whole
    rollout: nothing in a shape-driven rollout changes their 13
    frame-constant rows, so each frame refreshes only the position rows.
    The dense mode takes no such tables."""
    p = state.particles
    dev = p.pos.device
    n = p.pos.shape[0]
    mode = _contact_mode(contact_mode, n)
    tables0 = (pack_tables_for(p, spec, contact_tile_j) if mode == "block"
               else None)
    pos_traj = torch.as_tensor(shape_pos_traj, dtype=_F32, device=dev)
    quat_traj = torch.as_tensor(shape_quat_traj, dtype=_F32, device=dev)
    recs = []
    st = state
    for t in range(pos_traj.shape[0]):
        st = st._replace(shapes=st.shapes.moved_to(pos_traj[t], quat_traj[t]))
        st = xpbd_step(st, spec, substeps, iterations, contact_mode=mode,
                       rest_filter=rest_filter, contact_tile_j=contact_tile_j,
                       n_shapes_active=n_shapes_active, packed_tables=tables0)
        if record:
            recs.append(st.particles.pos)
    return st, (torch.stack(recs) if record else None)
