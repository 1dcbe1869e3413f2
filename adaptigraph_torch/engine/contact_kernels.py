"""Particle contacts: table packing, tile culling, and the contact kernels
with their plain PyTorch versions.

Counterpart of adaptigraph_tpu/engine/pallas_kernels.py for the `block`
and `dense` contact modes. Particle attributes are packed in two layouts
(rows (N_pad, 16) and its transpose cols (16, N_pad)); attribute rows:
0-2 pos, 3-5 pos_prev, 6 group, 7 inv_mass, 8 self_collide, 9-11 rest_pos,
12 active.

Kernels (kernels/csrc/contact.cu): K1 the block sweep, K2 the block
refinement, K3 the dense all-pairs sweep, K4 the kinematic-shape stage
fused into K1 (`shp` passed to the K1 wrapper). Each kernel wrapper runs
the kernel's plain version for tensors on the CPU and launches the CUDA
kernel for tensors on a GPU; it never falls back from one to the other.
Each counts its kernel launches in a plain integer attribute,
`<wrapper>.launches` (K4: `block_sparse_contact_deltas_packed
.fused_launches`, a part of K1's count).
"""

from __future__ import annotations

import torch

from adaptigraph_torch.engine.state import (
    SHAPE_BOX, SHAPE_CAPSULE, SHAPE_CONVEX)

TILE = 128  # row tile of the contact sweep (particles per kernel CTA)
_EPS = 1e-9
_F32 = torch.float32
_MAX_SHAPE_FLOATS = 8192  # K4's shared-memory shape + plane table


def pack_contact_tables(pos, pos_prev, group, inv_mass, self_collide, active,
                        rest_pos, tile: int = TILE, tile_j: int | None = None):
    """(rows (N_pad, 16), cols (16, N_pad)) attribute tables, both
    contiguous, N padded to a multiple of max(tile, tile_j) with inactive
    zero rows."""
    t = max(tile, tile_j or tile)
    n = pos.shape[0]
    n_pad = -(-n // t) * t
    cols = torch.zeros((16, n_pad), dtype=_F32, device=pos.device)
    cols[0:3, :n] = pos.T
    cols[3:6, :n] = pos_prev.T
    cols[6, :n] = group.to(_F32)
    cols[7, :n] = inv_mass
    cols[8, :n] = self_collide.to(_F32)
    cols[9:12, :n] = rest_pos.T
    cols[12, :n] = active.to(_F32)
    return cols.T.contiguous(), cols


def update_contact_tables(rows, cols, pos, pos_prev=None):
    """Refresh the position rows (0-2), and the substep-start rows (3-5)
    when `pos_prev` is given, IN PLACE, and return the tables. (The JAX
    version returns new arrays; every caller here overwrites these rows
    before the next read, so one pair of tables serves a whole rollout.)"""
    n = pos.shape[0]
    rows[:n, 0:3] = pos
    cols[0:3, :n] = pos.T
    if pos_prev is not None:
        rows[:n, 3:6] = pos_prev
        cols[3:6, :n] = pos_prev.T
    return rows, cols


def _stable_front(keep):
    """Per row, the column order that puts True entries first and False
    entries after, each in index order: `jax.lax.top_k` over 0/1 scores,
    whose ties go to the lower index (torch.topk makes no such promise)."""
    return torch.argsort((~keep).to(torch.int32), dim=1, stable=True)


def tile_overlap_blocks(pos, active, inflate, tile: int = TILE,
                        max_blocks: int | None = None,
                        tile_j: int | None = None):
    """Per-row-tile lists of col blocks whose inflated AABBs intersect.

    `pos` must be padded to a multiple of max(tile, tile_j) with inactive
    padding rows. Returns (block_idx (nb_rows, MAXB) int32, overlapping
    blocks first in index order; block_cnt (nb_rows,) int32; overflow 0-d
    int32, the overlapping blocks dropped by the MAXB cap)."""
    tile_j = tile_j or tile
    n = pos.shape[0]
    nb_i, nb_j = n // tile, n // tile_j
    act = active[:, None]
    p_lo = torch.where(act, pos, 3e37)  # inactive particles never overlap
    p_hi = torch.where(act, pos, -3e37)
    lo_i = p_lo.view(nb_i, tile, 3).amin(dim=1)
    hi_i = p_hi.view(nb_i, tile, 3).amax(dim=1)
    lo_j = p_lo.view(nb_j, tile_j, 3).amin(dim=1)
    hi_j = p_hi.view(nb_j, tile_j, 3).amax(dim=1)
    sep = ((lo_i[:, None, :] > hi_j[None, :, :] + inflate)
           | (lo_j[None, :, :] > hi_i[:, None, :] + inflate))
    overlap = ~torch.any(sep, dim=-1)  # (nb_i, nb_j)
    maxb = max_blocks or min(nb_j, 128)
    idx = _stable_front(overlap)[:, :maxb]
    total = overlap.sum(dim=1)
    cnt = torch.clamp(total, max=maxb).to(torch.int32)
    overflow = torch.clamp(total - maxb, min=0).sum().to(torch.int32)
    return idx.to(torch.int32), cnt, overflow


def _check_tables(rows, cols, block_idx, block_cnt, tile, tile_j):
    n_pad = cols.shape[1]
    if tile != TILE:
        raise ValueError(f"row tile must be {TILE}, got {tile}")
    if tile_j not in (128, 256) or n_pad % tile_j:
        raise ValueError(f"tile_j {tile_j} must be 128 or 256 and divide "
                         f"n_pad {n_pad}")
    if rows.shape != (n_pad, 16) or cols.shape != (16, n_pad):
        raise ValueError(f"tables must be (n_pad, 16) and (16, n_pad), got "
                         f"{tuple(rows.shape)} and {tuple(cols.shape)}")
    nb = n_pad // tile
    if block_idx.dim() != 2 or block_idx.shape[0] != nb or \
            not 0 < block_idx.shape[1] <= 128:
        raise ValueError(f"block_idx must be ({nb}, maxb <= 128), got "
                         f"{tuple(block_idx.shape)}")
    if block_cnt.shape != (nb,):
        raise ValueError(f"block_cnt must be ({nb},), got "
                         f"{tuple(block_cnt.shape)}")
    for name, t, dt in (("rows", rows, _F32), ("cols", cols, _F32),
                        ("block_idx", block_idx, torch.int32),
                        ("block_cnt", block_cnt, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != rows.device:
            raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")
    return n_pad


def _f32(v, device):
    """A float32 0-d tensor on `device`, so scalar products round in float32
    as the JAX version's do."""
    return torch.as_tensor(v, dtype=_F32, device=device).reshape(())


def device_scalars(device, *vals):
    """The kernels read their scalars from device memory: a 0-d tensor
    already on the device costs no host synchronization."""
    return torch.stack([_f32(v, device) for v in vals])


def _cuda_args(*tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return [t.data_ptr() for t in tensors]


def _launch_device(t):
    if t.device.type != "cuda":
        raise RuntimeError(f"the contact kernels run on CUDA or CPU tensors, "
                           f"not {t.device}")


# --- detection and projection, shared by both plain versions ---------------

def _gather_blocks(cols, block_idx, k, tile_j):
    """(nb, 16, tile_j) attributes of the k-th listed col block of every
    row tile."""
    cb = cols.view(16, cols.shape[1] // tile_j, tile_j)
    return cb[:, block_idx[:, k].long(), :].permute(1, 0, 2)


def _detect(r, c, dist, filter_dist, rest_filter: bool):
    """Eligible pairs closer than `dist` between row attrs r (nb, tile, 16)
    and col attrs c (nb, 16, tile_j). Returns (dx, dy, dz, d2, contact)."""
    dx = r[..., 0:1] - c[:, 0:1, :]
    dy = r[..., 1:2] - c[:, 1:2, :]
    dz = r[..., 2:3] - c[:, 2:3, :]
    d2 = dx * dx + dy * dy + dz * dz
    same_group = torch.abs(r[..., 6:7] - c[:, 6:7, :]) < 0.5
    if rest_filter:
        pair_sc = (r[..., 8:9] > 0.5) & (c[:, 8:9, :] > 0.5)
        rdx = r[..., 9:10] - c[:, 9:10, :]
        rdy = r[..., 10:11] - c[:, 10:11, :]
        rdz = r[..., 11:12] - c[:, 11:12, :]
        rest_near = (rdx * rdx + rdy * rdy + rdz * rdz
                     < filter_dist * filter_dist)
        collide = (~same_group) | (pair_sc & ~rest_near)
    else:
        collide = ~same_group
    wsum = r[..., 7:8] + c[:, 7:8, :]
    contact = ((d2 < dist * dist) & (d2 > 1e-14) & collide & (wsum > 0.0)
               & (r[..., 12:13] > 0.5) & (c[:, 12:13, :] > 0.5))
    return dx, dy, dz, d2, contact


def _pair_sums(r, c, rest_dist, friction, filter_dist, rest_filter: bool,
               mask=None):
    """The pair math of K1 and K3 between row attrs r (nb, tile, 16) and
    col attrs c (nb, 16, width): the distance test on every pair (and
    `mask` (nb, 1, 1) when given), the rest of the detection stage on the
    pairs that pass it, then projection + friction on the contact pairs,
    added back to their rows in (row, col) order. Each pair's arithmetic
    is _detect's, op for op, so the contacts are the same. Returns the row
    sums (nb * tile, 4) [delta_xyz, count]."""
    nb, tile = r.shape[0], r.shape[1]
    dx = r[..., 0:1] - c[:, 0:1, :]
    dy = r[..., 1:2] - c[:, 1:2, :]
    dz = r[..., 2:3] - c[:, 2:3, :]
    d2 = dx * dx + dy * dy + dz * dz
    near = (d2 < rest_dist * rest_dist) & (d2 > 1e-14)
    if mask is not None:
        near = near & mask
    b, i, j = near.nonzero(as_tuple=True)
    ri, cj = r[b, i], c[b, :, j]  # (K, 16) attributes of each near pair
    same_group = torch.abs(ri[:, 6] - cj[:, 6]) < 0.5
    if rest_filter:
        pair_sc = (ri[:, 8] > 0.5) & (cj[:, 8] > 0.5)
        rdx = ri[:, 9] - cj[:, 9]
        rdy = ri[:, 10] - cj[:, 10]
        rdz = ri[:, 11] - cj[:, 11]
        rest_near = (rdx * rdx + rdy * rdy + rdz * rdz
                     < filter_dist * filter_dist)
        collide = (~same_group) | (pair_sc & ~rest_near)
    else:
        collide = ~same_group
    ok = (collide & (ri[:, 7] + cj[:, 7] > 0.0) & (ri[:, 12] > 0.5)
          & (cj[:, 12] > 0.5))
    b, i, ri, cj = b[ok], i[ok], ri[ok], cj[ok]
    dx = ri[:, 0] - cj[:, 0]  # the same values as above, for these pairs
    dy = ri[:, 1] - cj[:, 1]
    dz = ri[:, 2] - cj[:, 2]
    d2 = dx * dx + dy * dy + dz * dz
    wi, wj = ri[:, 7], cj[:, 7]
    inv_dist = torch.rsqrt(d2 + _EPS)
    dist = d2 * inv_dist
    overlap = rest_dist - dist
    share = wi * (1.0 / (wi + wj + _EPS))
    mag = share * overlap * inv_dist
    mx = (ri[:, 0] - ri[:, 3]) - (cj[:, 0] - cj[:, 3])
    my = (ri[:, 1] - ri[:, 4]) - (cj[:, 1] - cj[:, 4])
    mz = (ri[:, 2] - ri[:, 5]) - (cj[:, 2] - cj[:, 5])
    rel_n = (mx * dx + my * dy + mz * dz) * (inv_dist * inv_dist)
    tx = mx - rel_n * dx
    ty = my - rel_n * dy
    tz = mz - rel_n * dz
    inv_tnorm = torch.rsqrt(tx * tx + ty * ty + tz * tz + _EPS)
    max_slide = torch.clamp(friction * overlap, min=0.0)
    fscale = torch.clamp(max_slide * inv_tnorm, max=1.0) * share
    vals = torch.stack([dx * mag - tx * fscale, dy * mag - ty * fscale,
                        dz * mag - tz * fscale, torch.ones_like(dx)], dim=1)
    out = torch.zeros((nb * tile, 4), dtype=_F32, device=r.device)
    return out.index_add_(0, b * tile + i, vals)


def block_sparse_contact_plain(n: int, rows, cols, rest_dist,
                               particle_friction, filter_dist, block_idx,
                               block_cnt, tile: int = TILE,
                               rest_filter: bool = True,
                               tile_j: int | None = None):
    """Plain PyTorch version of K1: loops k over max(block_cnt) on
    (nb, tile, tile_j) tensors, masked by each tile's count."""
    tile_j = tile_j or tile
    n_pad = cols.shape[1]
    nb = n_pad // tile
    dev = rows.device
    rest_dist, particle_friction, filter_dist = (
        _f32(v, dev) for v in (rest_dist, particle_friction, filter_dist))
    r = rows.view(nb, tile, 16)
    acc = torch.zeros((n_pad, 4), dtype=_F32, device=dev)
    kmax = int(block_cnt.max()) if nb else 0
    for k in range(kmax):
        acc += _pair_sums(r, _gather_blocks(cols, block_idx, k, tile_j),
                          rest_dist, particle_friction, filter_dist,
                          rest_filter, mask=(block_cnt > k)[:, None, None])
    return acc[:n, :3], acc[:n, 3]


def _check_shapes(shp, planes2d, shape_params, device):
    """The fused stage's inputs: shp (M, 16) float32, planes2d (M * P, 4)
    float32 or None, four shape parameters. Returns (M, P)."""
    if shape_params is None or len(shape_params) != 4:
        raise ValueError("shape_params must be (collision_distance, margin, "
                         "dynamic_friction, dt)")
    if shp.dim() != 2 or shp.shape[1] != 16 or shp.shape[0] == 0:
        raise ValueError(f"shp must be (M > 0, 16), got {tuple(shp.shape)}")
    m = shp.shape[0]
    p = 0
    if planes2d is not None and planes2d.numel():
        if planes2d.dim() != 2 or planes2d.shape[1] != 4 or \
                planes2d.shape[0] % m:
            raise ValueError(f"planes2d must be (M * P, 4) with M = {m}, "
                             f"got {tuple(planes2d.shape)}")
        p = planes2d.shape[0] // m
    if m * 16 + m * p * 4 > _MAX_SHAPE_FLOATS:
        raise ValueError(f"{m} shapes x {p} planes exceed the fused stage's "
                         f"{_MAX_SHAPE_FLOATS}-float shared-memory table")
    for name, t in (("shp", shp), ("planes2d", planes2d)):
        if t is None:
            continue
        if t.dtype != _F32:
            raise TypeError(f"{name} must be {_F32}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, rows on {device}")
    return m, p


def shape_stage_plain(pos, pos_prev, shp, planes2d, collision_distance,
                      margin, dynamic_friction, dt):
    """Plain PyTorch version of K4's stage: the JAX package's `_shape_stage`
    op for op, on (N,) vectors (its math, not collisions.py's: the two
    differ in rounding). pos / pos_prev (N, 3) current and substep-start
    positions; shp (M, 16) rows [kind, valid, size3, pos3, quat4 (xyzw),
    vel3, 0]; planes2d (M * P, 4) local halfspaces or None. `margin` is
    accepted and not used, as in the JAX stage; friction takes the
    frame's shape velocity times the substep's `dt`, as there. Returns
    (delta (N, 3), count (N,))."""
    m_shapes, n_planes = _check_shapes(
        shp, planes2d, (collision_distance, margin, dynamic_friction, dt),
        pos.device)
    cd, dyn, dt = (_f32(v, pos.device)
                   for v in (collision_distance, dynamic_friction, dt))
    eps2 = _EPS * _EPS
    px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    ux = px - pos_prev[:, 0]
    uy = py - pos_prev[:, 1]
    uz = pz - pos_prev[:, 2]
    zero = torch.zeros_like(px)
    ax = ay = az = cnt = zero
    for m in range(m_shapes):
        (kind, valid, hx, hy, hz, sx, sy, sz, qx, qy, qz, qw, vx, vy, vz,
         _) = shp[m].unbind()
        r00 = 1 - 2 * (qy * qy + qz * qz)
        r01 = 2 * (qx * qy - qz * qw)
        r02 = 2 * (qx * qz + qy * qw)
        r10 = 2 * (qx * qy + qz * qw)
        r11 = 1 - 2 * (qx * qx + qz * qz)
        r12 = 2 * (qy * qz - qx * qw)
        r20 = 2 * (qx * qz - qy * qw)
        r21 = 2 * (qy * qz + qx * qw)
        r22 = 1 - 2 * (qx * qx + qy * qy)
        wx, wy, wz = px - sx, py - sy, pz - sz
        qxp = r00 * wx + r10 * wy + r20 * wz
        qyp = r01 * wx + r11 * wy + r21 * wz
        qzp = r02 * wx + r12 * wy + r22 * wz

        # box
        dxb = torch.abs(qxp) - hx
        dyb = torch.abs(qyp) - hy
        dzb = torch.abs(qzp) - hz
        ox = torch.clamp(dxb, min=0.0)
        oy = torch.clamp(dyb, min=0.0)
        oz = torch.clamp(dzb, min=0.0)
        d2o = ox * ox + oy * oy + oz * oz
        inv_out = torch.rsqrt(d2o + eps2)
        dist_out = d2o * inv_out
        max_d = torch.maximum(dxb, torch.maximum(dyb, dzb))
        sd_box = dist_out + torch.clamp(max_d, max=0.0)
        # inside: face of least penetration, the first axis on ties
        is_x = (dxb >= dyb) & (dxb >= dzb)
        is_y = (~is_x) & (dyb >= dzb)
        is_z = ~(is_x | is_y)
        out_side = max_d > 0.0
        nbx = torch.where(out_side, ox * torch.sign(qxp) * inv_out,
                          torch.where(is_x, torch.sign(qxp), 0.0))
        nby = torch.where(out_side, oy * torch.sign(qyp) * inv_out,
                          torch.where(is_y, torch.sign(qyp), 0.0))
        nbz = torch.where(out_side, oz * torch.sign(qzp) * inv_out,
                          torch.where(is_z, torch.sign(qzp), 0.0))

        # capsule (axis +x; size = radius, half_len, _)
        a_c = torch.minimum(torch.maximum(qxp, -hy), hy)
        cdx = qxp - a_c
        d2c = cdx * cdx + qyp * qyp + qzp * qzp
        inv_dc = torch.rsqrt(d2c + eps2)
        sd_cap = d2c * inv_dc - hx

        # plane (local y-up) is the default
        is_box, is_cap = kind == SHAPE_BOX, kind == SHAPE_CAPSULE
        sd = torch.where(is_box, sd_box, torch.where(is_cap, sd_cap, qyp))
        nlx = torch.where(is_box, nbx, torch.where(is_cap, cdx * inv_dc, 0.0))
        nly = torch.where(is_box, nby, torch.where(is_cap, qyp * inv_dc, 1.0))
        nlz = torch.where(is_box, nbz, torch.where(is_cap, qzp * inv_dc, 0.0))

        if n_planes > 0:
            # convex polytope: running max over the halfspaces; the strict
            # > keeps the first plane of a tie
            sd_cx = torch.full_like(px, -3e37)
            nxx = nxy = nxz = zero
            any_valid = torch.zeros((), dtype=torch.bool, device=pos.device)
            for k in range(n_planes):
                n0, n1, n2, pd = planes2d[m * n_planes + k].unbind()
                pv = n0 * n0 + n1 * n1 + n2 * n2 > 0.25
                sp = torch.where(pv, qxp * n0 + qyp * n1 + qzp * n2 - pd,
                                 -3e37)
                take = sp > sd_cx
                sd_cx = torch.where(take, sp, sd_cx)
                nxx = torch.where(take, n0, nxx)
                nxy = torch.where(take, n1, nxy)
                nxz = torch.where(take, n2, nxz)
                any_valid = any_valid | pv
            sd_cx = torch.where(any_valid, sd_cx, 3e37)
            is_cx = kind == SHAPE_CONVEX
            sd = torch.where(is_cx, sd_cx, sd)
            nlx = torch.where(is_cx, nxx, nlx)
            nly = torch.where(is_cx, nxy, nly)
            nlz = torch.where(is_cx, nxz, nlz)

        # local->world normal (R @ n)
        nwx = r00 * nlx + r01 * nly + r02 * nlz
        nwy = r10 * nlx + r11 * nly + r12 * nlz
        nwz = r20 * nlx + r21 * nly + r22 * nlz

        pen = cd - sd
        cf = ((pen > 0.0) & (valid > 0.5)).to(_F32)
        # Coulomb friction on the tangential relative displacement
        rx = ux - vx * dt
        ry = uy - vy * dt
        rz = uz - vz * dt
        rel_n = rx * nwx + ry * nwy + rz * nwz
        tx = rx - nwx * rel_n
        ty = ry - nwy * rel_n
        tz = rz - nwz * rel_n
        t2 = tx * tx + ty * ty + tz * tz
        inv_t = torch.rsqrt(t2 + eps2)
        t_norm = t2 * inv_t
        max_slide = dyn * torch.abs(pen)
        scale = torch.clamp(max_slide / (t_norm + _EPS), max=1.0) * cf
        ax = ax + nwx * (pen * cf) - tx * scale
        ay = ay + nwy * (pen * cf) - ty * scale
        az = az + nwz * (pen * cf) - tz * scale
        cnt = cnt + cf
    return torch.stack([ax, ay, az], dim=1), cnt


def block_sparse_contact_deltas_packed(n: int, rows, cols, rest_dist,
                                       particle_friction, filter_dist,
                                       block_idx, block_cnt, tile: int = TILE,
                                       rest_filter: bool = True,
                                       tile_j: int | None = None,
                                       shp=None, planes2d=None,
                                       shape_params=None):
    """K1: contact and friction corrections over the listed tile blocks.
    Returns (delta (n, 3), count (n,)). CPU tensors take the plain version;
    CUDA tensors launch `ag_block_sparse_contact`.

    K4, the fused kinematic-shape stage: pass shp (M, 16) float32 rows
    [kind, valid, size3, pos3, quat4 (xyzw), vel3, 0], planes2d (M * P, 4)
    local halfspaces or None, and shape_params = (collision_distance,
    margin, dynamic_friction, dt). delta and count then include the shape
    contacts (`pair + shape`, as the JAX wrapper adds them); CUDA tensors
    launch `ag_block_sparse_contact_shapes`, CPU tensors add
    shape_stage_plain to the plain sweep."""
    tile_j = tile_j or tile
    n_pad = _check_tables(rows, cols, block_idx, block_cnt, tile, tile_j)
    fuse = shp is not None
    if fuse:
        n_shapes, n_planes = _check_shapes(shp, planes2d, shape_params,
                                           rows.device)
    if rows.device.type == "cpu":
        delta, count = block_sparse_contact_plain(
            n, rows, cols, rest_dist, particle_friction, filter_dist,
            block_idx, block_cnt, tile, rest_filter, tile_j)
        if fuse:
            d_s, c_s = shape_stage_plain(rows[:n, 0:3], rows[:n, 3:6], shp,
                                         planes2d, *shape_params)
            delta, count = delta + d_s, count + c_s
        return delta, count
    _launch_device(rows)
    from adaptigraph_torch.kernels import build

    lib = build.load()
    delta = torch.empty((n, 3), dtype=_F32, device=rows.device)
    count = torch.empty((n,), dtype=_F32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    if fuse:
        scal = device_scalars(rows.device, rest_dist, particle_friction,
                              filter_dist, *shape_params)
        planes_ptr = (_cuda_args(planes2d)[0] if n_planes else None)
        err = lib.ag_block_sparse_contact_shapes(
            *_cuda_args(rows, cols, block_idx, block_cnt, scal, shp),
            planes_ptr, *_cuda_args(delta, count), n, n_pad,
            block_idx.shape[1], tile_j, int(rest_filter), n_shapes, n_planes,
            stream)
        build.check(lib, err, "ag_block_sparse_contact_shapes")
        block_sparse_contact_deltas_packed.fused_launches += 1
    else:
        scal = device_scalars(rows.device, rest_dist, particle_friction,
                              filter_dist)
        err = lib.ag_block_sparse_contact(
            *_cuda_args(rows, cols, block_idx, block_cnt, scal, delta, count),
            n, n_pad, block_idx.shape[1], tile_j, int(rest_filter), stream)
        build.check(lib, err, "ag_block_sparse_contact")
    block_sparse_contact_deltas_packed.launches += 1
    return delta, count


block_sparse_contact_deltas_packed.launches = 0
block_sparse_contact_deltas_packed.fused_launches = 0


def refine_blocks_plain(rows, cols, keep_dist, filter_dist, block_idx,
                        block_cnt, tile: int = TILE, rest_filter: bool = True,
                        tile_j: int | None = None):
    """Plain PyTorch version of K2: flag each listed slot whose block holds
    an eligible pair closer than keep_dist, then put the flagged slots
    first and the rest after, each in slot order."""
    tile_j = tile_j or tile
    nb = cols.shape[1] // tile
    keep_dist, filter_dist = (_f32(v, rows.device)
                              for v in (keep_dist, filter_dist))
    r = rows.view(nb, tile, 16)
    flags = torch.zeros(block_idx.shape, dtype=torch.bool, device=rows.device)
    kmax = int(block_cnt.max()) if nb else 0
    for k in range(kmax):
        c = _gather_blocks(cols, block_idx, k, tile_j)
        contact = _detect(r, c, keep_dist, filter_dist, rest_filter)[-1]
        flags[:, k] = contact.flatten(1).any(dim=1) & (block_cnt > k)
    new_idx = torch.gather(block_idx, 1, _stable_front(flags))
    return new_idx, flags.sum(dim=1).to(torch.int32)


def refine_overlap_blocks_packed(n: int, rows, cols, keep_dist, filter_dist,
                                 block_idx, block_cnt, tile: int = TILE,
                                 rest_filter: bool = True,
                                 tile_j: int | None = None):
    """K2: shrink tile_overlap_blocks' lists to the blocks that hold an
    eligible pair within `keep_dist`. Returns (block_idx, block_cnt) in the
    same layout; counts only shrink. CPU tensors take the plain version;
    CUDA tensors launch `ag_refine_blocks`. (`n` is kept for signature
    parity with the JAX version; padding rows are inactive.)"""
    tile_j = tile_j or tile
    n_pad = _check_tables(rows, cols, block_idx, block_cnt, tile, tile_j)
    if rows.device.type == "cpu":
        return refine_blocks_plain(rows, cols, keep_dist, filter_dist,
                                   block_idx, block_cnt, tile, rest_filter,
                                   tile_j)
    _launch_device(rows)
    from adaptigraph_torch.kernels import build

    lib = build.load()
    scal = device_scalars(rows.device, keep_dist, filter_dist)
    new_idx = torch.empty_like(block_idx)
    new_cnt = torch.empty_like(block_cnt)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.ag_refine_blocks(
        *_cuda_args(rows, cols, block_idx, block_cnt, scal, new_idx, new_cnt),
        n_pad, block_idx.shape[1], tile_j, int(rest_filter), stream)
    build.check(lib, err, "ag_refine_blocks")
    refine_overlap_blocks_packed.launches += 1
    return new_idx, new_cnt


refine_overlap_blocks_packed.launches = 0


def _check_dense_tables(rows, cols):
    n_pad = cols.shape[1]
    if n_pad % TILE or rows.shape != (n_pad, 16) or cols.shape != (16, n_pad):
        raise ValueError(f"tables must be (n_pad, 16) and (16, n_pad) with "
                         f"n_pad a multiple of {TILE}, got {tuple(rows.shape)}"
                         f" and {tuple(cols.shape)}")
    for name, t in (("rows", rows), ("cols", cols)):
        if t.dtype != _F32:
            raise TypeError(f"{name} must be {_F32}, got {t.dtype}")
    if cols.device != rows.device:
        raise ValueError(f"cols is on {cols.device}, rows on {rows.device}")
    return n_pad


def dense_contact_plain(n: int, rows, cols, rest_dist, particle_friction,
                        filter_dist):
    """Plain PyTorch version of K3: every pair, the rest filter on, one
    128-row tile at a time against all columns (so memory stays at
    (128, n_pad) per tensor)."""
    n_pad = _check_dense_tables(rows, cols)
    dev = rows.device
    rest_dist, particle_friction, filter_dist = (
        _f32(v, dev) for v in (rest_dist, particle_friction, filter_dist))
    c = cols.view(1, 16, n_pad)
    out = torch.empty((n_pad, 4), dtype=_F32, device=dev)
    for i0 in range(0, n_pad, TILE):
        out[i0:i0 + TILE] = _pair_sums(
            rows[i0:i0 + TILE].view(1, TILE, 16), c, rest_dist,
            particle_friction, filter_dist, True)
    return out[:n, :3], out[:n, 3]


def dense_contact_deltas_packed(n: int, rows, cols, rest_dist,
                                particle_friction, filter_dist):
    """K3: all-pairs contact and friction corrections over prepacked
    tables (n_pad a multiple of 128). Returns (delta (n, 3), count (n,)).
    CPU tensors take the plain version; CUDA tensors launch
    `ag_dense_contact`."""
    n_pad = _check_dense_tables(rows, cols)
    if rows.device.type == "cpu":
        return dense_contact_plain(n, rows, cols, rest_dist,
                                   particle_friction, filter_dist)
    _launch_device(rows)
    from adaptigraph_torch.kernels import build

    lib = build.load()
    scal = device_scalars(rows.device, rest_dist, particle_friction,
                          filter_dist)
    delta = torch.empty((n, 3), dtype=_F32, device=rows.device)
    count = torch.empty((n,), dtype=_F32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.ag_dense_contact(*_cuda_args(rows, cols, scal, delta, count),
                               n, n_pad, stream)
    build.check(lib, err, "ag_dense_contact")
    dense_contact_deltas_packed.launches += 1
    return delta, count


dense_contact_deltas_packed.launches = 0


def dense_contact_deltas(pos, pos_prev, group, inv_mass, self_collide, active,
                         rest_pos, rest_dist, particle_friction, filter_dist):
    """K3 from unpacked particle arrays (packs the tables first); the JAX
    dense_contact_deltas' signature."""
    rows, cols = pack_contact_tables(pos, pos_prev, group, inv_mass,
                                     self_collide, active, rest_pos)
    return dense_contact_deltas_packed(pos.shape[0], rows, cols, rest_dist,
                                       particle_friction, filter_dist)


def block_sparse_contact_deltas(pos, pos_prev, group, inv_mass, self_collide,
                                active, rest_pos, rest_dist,
                                particle_friction, filter_dist, block_idx,
                                block_cnt, tile: int = TILE,
                                rest_filter: bool = True,
                                tile_j: int | None = None):
    """K1 from unpacked particle arrays (packs the tables first)."""
    rows, cols = pack_contact_tables(pos, pos_prev, group, inv_mass,
                                     self_collide, active, rest_pos, tile=tile,
                                     tile_j=tile_j)
    return block_sparse_contact_deltas_packed(
        pos.shape[0], rows, cols, rest_dist, particle_friction, filter_dist,
        block_idx, block_cnt, tile=tile, rest_filter=rest_filter,
        tile_j=tile_j)


def refine_overlap_blocks(pos, pos_prev, group, inv_mass, self_collide,
                          active, rest_pos, keep_dist, filter_dist, block_idx,
                          block_cnt, tile: int = TILE, rest_filter: bool = True,
                          tile_j: int | None = None):
    """K2 from unpacked particle arrays (packs the tables first)."""
    rows, cols = pack_contact_tables(pos, pos_prev, group, inv_mass,
                                     self_collide, active, rest_pos, tile=tile,
                                     tile_j=tile_j)
    return refine_overlap_blocks_packed(
        pos.shape[0], rows, cols, keep_dist, filter_dist, block_idx,
        block_cnt, tile=tile, rest_filter=rest_filter, tile_j=tile_j)
