"""XPBD particle solver: the simulator frame, ported from
adaptigraph_tpu/engine/solver.py.

Per substep: integrate -> `iterations` x Jacobi projection of {particle
contacts + friction, kinematic-shape contacts + friction, offset-family
springs, springs, shape-matching clusters, global cluster}, summed in
that order -> plastic flow (when the state carries `cluster_rest`) ->
velocity update (dissipation, sleeping).

Particle contacts run in one of three modes. `block`: the AABB-culled
tile sweep of contact_kernels (K1) over block lists built once per frame
and refined by K2; with `n_shapes_active` set, the kinematic-shape pass
is fused into K1 (K4). `dense`: the all-pairs sweep (K3). `sparse`: a
fixed-K neighbor list built once per frame (neighbors.neighbor_list up
to 1,024 particles, cells.cell_list_neighbors above) and torch gathers,
no contact kernel. Substeps and iterations are Python loops (the JAX
version's lax.scan / fori_loop).

Springs run as static-offset families (slices, the cloth grid), through
a per-particle incidence table (gathers) or by scatter-add. Clusters run
as two float32 matrix products (the membership matrix, rope), as a
cumsum over contiguous segments (granular), or by member gathers (any
other layout, and every layout once plastic flow reshapes the rest
offsets). Products run with TF32 off: lossy matmul precision washes out
friction (the JAX solver runs them at Precision.HIGHEST for the same
reason).
"""

from __future__ import annotations

import torch

from adaptigraph_torch.engine.cells import cell_list_neighbors
from adaptigraph_torch.engine.collisions import shape_contact_deltas
from adaptigraph_torch.engine.contact_kernels import (
    TILE, block_sparse_contact_deltas_packed, dense_contact_deltas_packed,
    pack_contact_tables, refine_overlap_blocks_packed, tile_overlap_blocks,
    update_contact_tables)
from adaptigraph_torch.engine.neighbors import (
    neighbor_list, sq_dist, sq_dist_fma)
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
    """The contact mode a frame runs: `mode`, else auto_contact_mode(n)."""
    if mode is None:
        mode = auto_contact_mode(n)
    if mode not in ("block", "dense", "sparse"):
        raise ValueError(f"unknown contact_mode {mode!r}")
    return mode


def _block_tables(particles: ParticleState, spec: SceneSpec, tile_j: int):
    """The block sweep's contact tables of `particles` at `tile_j`."""
    return pack_contact_tables(
        particles.pos, particles.pos, particles.group, particles.inv_mass,
        particles.self_collide, particles.active, spec.rest_pos,
        tile_j=tile_j)


def pack_tables_for(particles: ParticleState, spec: SceneSpec):
    """The frame-constant contact tables of `particles` iff the auto contact
    mode is 'block' (at auto_tile_j); None otherwise, as the dense and
    sparse modes take no tables. The JAX package's contract: callers that
    pre-pack for xpbd_step's auto mode use this, so the mode and tile
    thresholds stay in step with it; callers that need a given tile width
    call contact_kernels.pack_contact_tables."""
    n = particles.pos.shape[0]
    if auto_contact_mode(n) != "block":
        return None
    return _block_tables(particles, spec, auto_tile_j(n))


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


def _spring_terms(pos, inv_mass, springs):
    """Per-spring corrections (S, 3), masked, with the endpoint masses and
    the valid mask."""
    i, j = springs.idx[:, 0].long(), springs.idx[:, 1].long()
    d = pos[i] - pos[j]
    length = torch.sqrt(sq_dist(d))
    direction = d / (length[:, None] + _EPS)
    c = length - springs.rest
    wi, wj = inv_mass[i], inv_mass[j]
    wsum = wi + wj
    ok = springs.valid & (wsum > 0)
    corr = -(springs.stiffness * c / (wsum + _EPS))[:, None] * direction
    corr = torch.where(ok[:, None], corr, torch.zeros_like(corr))
    return corr, wi, wj, ok


def _spring_deltas(pos, inv_mass, springs):
    """Distance-constraint corrections, scatter-added per endpoint
    (index_add_). On the CPU the sums run in index order, as the JAX
    version's CPU scatter does; on CUDA their float sums follow no fixed
    order. No builder reaches this form: attach_incidence always builds
    the incidence table of the gather form."""
    i, j = springs.idx[:, 0].long(), springs.idx[:, 1].long()
    corr, wi, wj, ok = _spring_terms(pos, inv_mass, springs)
    n = pos.shape[0]
    delta = pos.new_zeros((n, 3))
    delta.index_add_(0, i, wi[:, None] * corr)
    delta.index_add_(0, j, -wj[:, None] * corr)
    okf = ok.to(pos.dtype)
    cnt = pos.new_zeros((n,))
    cnt.index_add_(0, i, okf)
    cnt.index_add_(0, j, okf)
    return delta, cnt


def _spring_deltas_gather(pos, inv_mass, springs, inc):
    """Distance-constraint corrections gathered back to the endpoints
    through the incidence table (state.SpringIncidence)."""
    corr, _, _, ok = _spring_terms(pos, inv_mass, springs)
    sid = inc.idx.long()
    g = corr[sid]  # (N, D, 3)
    delta = torch.sum(g * inc.sign[..., None], dim=1) * inv_mass[:, None]
    okg = ok[sid] & (inc.sign != 0)
    cnt = torch.sum(okg, dim=1).to(pos.dtype)
    return delta, cnt


def _spring_deltas_offset(pos, inv_mass, os):
    """Distance constraints of static-offset spring families
    (state.OffsetSprings): endpoint reads are slices and the reduction is
    a zero-padded concatenate and sum, no gather and no scatter. The JAX
    version splits the components into (N,) arrays (a TPU layout matter);
    here they stay (N, 3), with the same arithmetic on every element:
    d2 = dx*dx + dy*dy + dz*dz in that order, the families in `offsets`
    order, and for each a + [wi*c, 0] - [0, wj*c]."""
    n = pos.shape[0]
    acc = torch.zeros_like(pos)
    cnt = pos.new_zeros((n,))
    for f, o in enumerate(os.offsets):
        d = pos[: n - o] - pos[o:]
        d2 = sq_dist(d)
        inv_len = torch.rsqrt(d2 + _EPS)
        length = d2 * inv_len
        c = length - os.rest[f, : n - o]
        wi = inv_mass[: n - o]
        wj = inv_mass[o:]
        wsum = wi + wj
        ok = os.valid[f, : n - o] & (wsum > 0)
        okf = ok.to(pos.dtype)
        mag = -(os.stiffness[f, : n - o] * c / (wsum + _EPS)) * inv_len * okf
        cv = mag[:, None] * d
        z3 = pos.new_zeros((o, 3))
        acc = (acc + torch.cat([wi[:, None] * cv, z3])
               - torch.cat([z3, wj[:, None] * cv]))
        z1 = pos.new_zeros((o,))
        cnt = cnt + torch.cat([okf, z1])
        cnt = cnt + torch.cat([z1, okf])
    return acc, cnt


def precompute_contact_static(inv_mass, group, self_collide, active, nbr_idx,
                              nbr_valid, rest_pos=None, filter_dist=0.0):
    """The sparse mode's per-frame contact invariants: pair eligibility
    (group, self-collision, and the rest-distance filter: same-group pairs
    closer than filter_dist at rest never collide) and mass shares. Rest
    distances are rounded as the JAX package's on the CPU (sq_dist_fma), a
    choice made for parity (see neighbors)."""
    nbr = nbr_idx.long()
    gi = group[:, None]
    gj = group[nbr]
    collide = (gi != gj) | (self_collide[:, None] & self_collide[nbr])
    if rest_pos is not None:
        rest_d = torch.sqrt(sq_dist_fma(rest_pos[:, None, :] - rest_pos[nbr]))
        collide = collide & ~((gi == gj) & (rest_d < filter_dist))
    wi = inv_mass[:, None]
    wj = inv_mass[nbr]
    wsum = wi + wj
    eligible = nbr_valid & collide & (wsum > 0)
    share = wi / (wsum + _EPS)
    return eligible, share


def _particle_contact_deltas(pos, pos_prev, nbr_idx, eligible, share,
                             rest_dist, particle_friction, pj_prev=None):
    """Particle-particle non-penetration and friction over the fixed-K
    neighbor list, each pair from both sides. `pj_prev`, the substep-start
    neighbor positions, is gathered once a substep by the caller."""
    nbr = nbr_idx.long()
    pj = pos[nbr]  # (N, K, 3)
    if pj_prev is None:
        pj_prev = pos_prev[nbr]
    d = pos[:, None, :] - pj
    dist = torch.sqrt(sq_dist(d))
    direction = d / (dist[..., None] + _EPS)
    overlap = rest_dist - dist  # > 0 when penetrating
    contact = eligible & (overlap > 0)
    delta_n = direction * (share * overlap)[..., None]
    # friction: tangential relative displacement over the substep
    rel = (pos - pos_prev)[:, None, :] - (pj - pj_prev)
    rel_t = rel - direction * torch.sum(rel * direction, dim=-1, keepdim=True)
    rel_t_norm = torch.sqrt(sq_dist(rel_t))[..., None]
    max_slide = particle_friction * overlap[..., None]
    scale = torch.clamp(torch.clamp(max_slide, min=0.0)
                        / (rel_t_norm + _EPS), max=1.0)
    delta_f = -rel_t * scale * share[..., None]
    delta = torch.where(contact[..., None], delta_n + delta_f,
                        torch.zeros_like(delta_n))
    return (torch.sum(delta, dim=1),
            torch.sum(contact.to(pos.dtype), dim=1))


def _cluster_deltas(pos, clusters, cluster_rot, rest=None, inc=None):
    """Shape-matching corrections by member gathers, for any cluster
    layout. `rest` overrides clusters.rest once plastic flow has reshaped
    the rest offsets. With `inc` (state.ClusterIncidence) the corrections
    are gathered back to the particles; without it they are scatter-added
    (index_add_: in index order on the CPU, as the JAX version's CPU
    scatter; in no fixed order on CUDA; no builder reaches this form, as
    attach_incidence always builds the incidence table). The covariance is
    a float32 product with TF32 off (Precision.HIGHEST in JAX). Returns
    (delta, count, new rotations)."""
    member = clusters.member.long()
    mvalid = clusters.member_valid
    if rest is None:
        rest = clusters.rest
    p = pos[member]  # (C, K, 3)
    mv = mvalid.to(pos.dtype)[..., None]
    nmem = torch.clamp(torch.sum(mv, dim=1), min=1.0)  # (C, 1)
    com = torch.sum(p * mv, dim=1) / nmem
    centered = (p - com[:, None, :]) * mv
    a = torch.einsum("cki,ckj->cij", centered, rest * mv)
    q_new = geo.extract_rotation(a, cluster_rot, iterations=6)
    q_new = torch.where(clusters.valid[:, None], q_new, cluster_rot)
    goal = com[:, None, :] + geo.quat_rotate(q_new[:, None, :], rest)
    corr = (goal - p) * clusters.stiffness[:, None, None]
    ok = mvalid & clusters.valid[:, None]
    corr = torch.where(ok[..., None], corr, torch.zeros_like(corr))
    n = pos.shape[0]
    if inc is not None:
        slot = inc.idx.long()
        g = corr.reshape(-1, 3)[slot]  # (N, D, 3)
        gv = (ok.reshape(-1)[slot] & inc.valid).to(pos.dtype)
        delta = torch.sum(g * gv[..., None], dim=1)
        cnt = torch.sum(gv, dim=1)
    else:
        flat = member.reshape(-1)
        delta = pos.new_zeros((n, 3)).index_add_(0, flat, corr.reshape(-1, 3))
        cnt = pos.new_zeros((n,)).index_add_(
            0, flat, ok.to(pos.dtype).reshape(-1))
    return delta, cnt, q_new


def _plastic_flow(pos, clusters, cluster_rot, rest, threshold, creep):
    """Shape-matching plasticity, once a substep: clusters whose RMS
    deviation from the rest shape (in the rotated-back local frame) exceeds
    `threshold` move `creep` of it into their rest offsets, which are then
    re-centred."""
    member = clusters.member.long()
    mv = clusters.member_valid.to(pos.dtype)[..., None]
    nmem = torch.clamp(torch.sum(mv, dim=1), min=1.0)
    p = pos[member]
    com = torch.sum(p * mv, dim=1) / nmem
    # rotate the deformed configuration back into the rest frame
    local = geo.quat_rotate(geo.quat_conjugate(cluster_rot)[:, None, :],
                            (p - com[:, None, :])) * mv
    dev = (local - rest) * mv
    rms = torch.sqrt(torch.sum(dev * dev, dim=(1, 2)) / nmem[:, 0])  # (C,)
    flow = (rms > threshold) & clusters.valid
    rate = torch.where(flow, creep, torch.zeros_like(creep))
    new_rest = rest + rate[:, None, None] * dev
    return (new_rest - torch.sum(new_rest * mv, dim=1, keepdim=True)
            / nmem[:, :, None]) * mv


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
             cluster_rest, spec: SceneSpec, shapes: ShapeSet, s_pos, s_quat,
             s_vel, dt, iterations: int, mode: str, blocks, tables,
             rest_filter: bool, tile_j: int, n_shapes_active: int | None,
             neighbors):
    p = particles
    prm = spec.params
    mov = ((p.inv_mass > 0) & p.active).to(p.pos.dtype)[:, None]
    # zero-capacity spring / cluster sets and a zero-row global_rest mean
    # "this scene has none": those passes do not run
    has_springs = spec.springs.idx.shape[0] > 0
    has_offset_springs = (spec.offset_springs is not None
                          and len(spec.offset_springs.offsets) > 0)
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
    # here, once per substep; the sparse mode gathers the neighbors'
    # substep-start positions here)
    if mode == "block":
        rows, cols = update_contact_tables(*tables, pos_prev,
                                           pos_prev=pos_prev)
        block_idx, block_cnt = blocks
    elif mode == "dense":
        rows, cols = pack_contact_tables(
            pos_prev, pos_prev, p.group, p.inv_mass, p.self_collide,
            p.active, spec.rest_pos)
    else:
        nbr_idx, eligible, share = neighbors
        pj_prev = pos_prev[nbr_idx.long()]
    fuse_shapes = mode == "block" and bool(n_shapes_active)
    shape_kw = {}
    if fuse_shapes:
        shp, planes2d = _shape_table(shapes, s_pos, s_quat, s_vel,
                                     n_shapes_active)
        shape_kw = dict(shp=shp, planes2d=planes2d, shape_params=(
            prm.collision_distance, prm.shape_collision_margin,
            prm.dynamic_friction, dt))

    for _ in range(iterations):
        if mode == "block":
            update_contact_tables(rows, cols, pos)
            delta, cnt = block_sparse_contact_deltas_packed(
                n, rows, cols, prm.solid_rest_distance,
                prm.particle_friction, prm.collide_filter_dist, block_idx,
                block_cnt, rest_filter=rest_filter, tile_j=tile_j, **shape_kw)
        elif mode == "dense":
            update_contact_tables(rows, cols, pos)
            delta, cnt = dense_contact_deltas_packed(
                n, rows, cols, prm.solid_rest_distance,
                prm.particle_friction, prm.collide_filter_dist)
        else:
            delta, cnt = _particle_contact_deltas(
                pos, pos_prev, nbr_idx, eligible, share,
                prm.solid_rest_distance, prm.particle_friction,
                pj_prev=pj_prev)
        if not fuse_shapes:
            delta_k, cnt_k = shape_contact_deltas(
                pos, pos_prev, shapes, s_pos, s_quat, s_vel,
                prm.collision_distance, prm.shape_collision_margin,
                prm.dynamic_friction, dt)
            delta = delta + delta_k
            cnt = cnt + cnt_k
        if has_offset_springs:
            delta_o, cnt_o = _spring_deltas_offset(pos, p.inv_mass,
                                                   spec.offset_springs)
            delta = delta + delta_o
            cnt = cnt + cnt_o
        if has_springs:
            if spec.spring_inc is not None:
                delta_s, cnt_s = _spring_deltas_gather(
                    pos, p.inv_mass, spec.springs, spec.spring_inc)
            else:
                delta_s, cnt_s = _spring_deltas(pos, p.inv_mass, spec.springs)
            delta = delta + delta_s
            cnt = cnt + cnt_s
        if has_clusters:
            # plastic flow reshapes the rest offsets, which the matmul and
            # segment forms fold into static tables: it takes the gather
            # form
            if spec.cluster_mm is not None and cluster_rest is None:
                delta_m, cnt_m, cluster_rot = _cluster_deltas_matmul(
                    pos, spec.rest_pos, spec.clusters, cluster_rot,
                    spec.cluster_mm)
            elif spec.cluster_seg is not None and cluster_rest is None:
                delta_m, cnt_m, cluster_rot = _cluster_deltas_segments(
                    pos, spec.rest_pos, spec.clusters, cluster_rot,
                    spec.cluster_seg)
            else:
                delta_m, cnt_m, cluster_rot = _cluster_deltas(
                    pos, spec.clusters, cluster_rot, rest=cluster_rest,
                    inc=spec.cluster_inc)
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

    if has_clusters and cluster_rest is not None:
        cluster_rest = _plastic_flow(pos, spec.clusters, cluster_rot,
                                     cluster_rest, prm.plastic_threshold,
                                     prm.plastic_creep)

    vel = (pos - pos_prev) / dt
    vel = vel * torch.clamp(1.0 - prm.dissipation * dt, min=0.0)
    # sleeping: freeze particles moving slower than the threshold
    slow = torch.linalg.vector_norm(vel, dim=-1, keepdim=True) < prm.sleep_threshold
    pos = torch.where(slow, pos_prev, pos)
    vel = torch.where(slow, torch.zeros_like(vel), vel)
    return p._replace(pos=pos, vel=vel), cluster_rot, global_rot, cluster_rest


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


def frame_neighbors(particles: ParticleState, spec: SceneSpec,
                    neighbor_k: int):
    """The sparse mode's neighbor find, once a frame: neighbor_list up to
    1,024 particles, the hashed cell list above, at radius * 1.5, then the
    pairs' eligibility and mass shares. Returns (idx, eligible, share)."""
    p0, prm = particles, spec.params
    nfind = neighbor_list if p0.pos.shape[0] <= 1024 else cell_list_neighbors
    nbr_idx, nbr_valid = nfind(p0.pos, prm.radius * 1.5, p0.active,
                               k=neighbor_k)
    eligible, share = precompute_contact_static(
        p0.inv_mass, p0.group, p0.self_collide, p0.active, nbr_idx, nbr_valid,
        rest_pos=spec.rest_pos, filter_dist=prm.collide_filter_dist)
    return nbr_idx, eligible, share


def xpbd_step(state: SceneState, spec: SceneSpec, substeps: int,
              iterations: int, neighbor_k: int = 24, *,
              contact_mode: str | None = None,
              rest_filter: bool | None = None,
              contact_tile_j: int | None = None,
              n_shapes_active: int | None = None,
              packed_tables=None) -> SceneState:
    """One outer sim frame (dt = params.dt): kinematic shapes move from
    their prev pose to their current pose across the substeps; particles
    respond. Runs on the device the state's tensors lie on. Takes the JAX
    xpbd_step's positional arguments (up to `neighbor_k`) in its order;
    the rest are keyword-only, so a JAX-style call that passes the JAX
    version's `dense_contacts` positionally fails rather than binding it
    to another parameter.

    contact_mode: 'block' (K1 over K2-refined block lists), 'dense' (K3) or
    'sparse' (a neighbor list of `neighbor_k` a particle, built once a
    frame; torch gathers, no contact kernel); None picks by size
    (auto_contact_mode). rest_filter: False when no particle
    self-collides (drops the rest-distance filter); None = True; the dense
    and sparse modes always filter. n_shapes_active: in block mode, fuse
    the shape pass over the first that many shape slots into K1 (K4); the
    other modes keep the separate pass. packed_tables: block-mode tables
    whose 13 frame-constant rows are current (see rollout_steps); their
    position rows are overwritten in place. A state with `cluster_rest`
    set runs plastic flow and returns the new rest offsets.
    Sets torch.backends' TF32 switches off (full-float32 matmuls)."""
    _full_f32_matmul()
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
    tables = blocks = neighbors = None
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if mode == "block":
        if packed_tables is not None:
            tables = update_contact_tables(*packed_tables, p0.pos,
                                           pos_prev=p0.pos)
        else:
            tables = _block_tables(p0, spec, tj)
        block_idx, block_cnt, overflow, keep_dist = frame_block_lists(
            p0, spec, s_vel, tj)
        blocks = refine_overlap_blocks_packed(
            n, *tables, keep_dist, prm.collide_filter_dist, block_idx,
            block_cnt, rest_filter=rest_filter, tile_j=tj)
    elif mode == "sparse":
        neighbors = frame_neighbors(p0, spec, neighbor_k)

    ts = (torch.arange(substeps, dtype=_F32, device=dev) + 1.0) / substeps
    particles, cl_rot, gl_rot = p0, state.cluster_rot, state.global_rot
    cl_rest = state.cluster_rest
    for k in range(substeps):
        t = ts[k]
        s_pos = shapes.prev_pos + (shapes.pos - shapes.prev_pos) * t
        s_quat = _nlerp(shapes.prev_quat, shapes.quat, t)
        particles, cl_rot, gl_rot, cl_rest = _substep(
            particles, cl_rot, gl_rot, cl_rest, spec, shapes, s_pos, s_quat,
            s_vel, dt_sub, iterations, mode, blocks, tables, rest_filter, tj,
            n_shapes_active, neighbors)
    prior = torch.as_tensor(state.contact_overflow, dtype=torch.int32,
                            device=dev)
    return SceneState(particles=particles, shapes=shapes, cluster_rot=cl_rot,
                      global_rot=gl_rot, cluster_rest=cl_rest,
                      contact_overflow=prior + overflow)


def rollout_steps(state: SceneState, spec: SceneSpec, shape_pos_traj,
                  shape_quat_traj, substeps: int, iterations: int,
                  neighbor_k: int = 24, *, record: bool = True,
                  contact_mode: str | None = None,
                  rest_filter: bool | None = None,
                  contact_tile_j: int | None = None,
                  n_shapes_active: int | None = None):
    """Run a whole tool trajectory: T outer frames. Takes the JAX
    rollout_steps' positional arguments (up to `neighbor_k`) in its order;
    the rest are keyword-only, as xpbd_step's are.

    shape_pos_traj (T, M, 3), shape_quat_traj (T, M, 4): per-frame target
    poses of every kinematic shape (numpy or tensors). Returns
    (final_state, recorded positions (T, N, 3) if `record` else None).
    In block mode the contact tables are packed once for the whole
    rollout: nothing in a shape-driven rollout changes their 13
    frame-constant rows, so each frame refreshes only the position rows.
    The dense and sparse modes take no such tables."""
    p = state.particles
    dev = p.pos.device
    n = p.pos.shape[0]
    mode = _contact_mode(contact_mode, n)
    tables0 = (_block_tables(p, spec, contact_tile_j or auto_tile_j(n))
               if mode == "block" else None)
    pos_traj = torch.as_tensor(shape_pos_traj, dtype=_F32, device=dev)
    quat_traj = torch.as_tensor(shape_quat_traj, dtype=_F32, device=dev)
    recs = []
    st = state
    for t in range(pos_traj.shape[0]):
        st = st._replace(shapes=st.shapes.moved_to(pos_traj[t], quat_traj[t]))
        st = xpbd_step(st, spec, substeps, iterations, neighbor_k,
                       contact_mode=mode, rest_filter=rest_filter,
                       contact_tile_j=contact_tile_j,
                       n_shapes_active=n_shapes_active, packed_tables=tables0)
        if record:
            recs.append(st.particles.pos)
    return st, (torch.stack(recs) if record else None)
