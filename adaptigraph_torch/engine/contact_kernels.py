"""Block-sparse particle contacts: table packing, tile culling, and the two
contact kernels with their plain PyTorch versions.

Counterpart of adaptigraph_tpu/engine/pallas_kernels.py for the `block`
contact mode. Particle attributes are packed in two layouts (rows
(N_pad, 16) and its transpose cols (16, N_pad)); attribute rows: 0-2 pos,
3-5 pos_prev, 6 group, 7 inv_mass, 8 self_collide, 9-11 rest_pos,
12 active.

Each kernel wrapper runs the kernel's plain version for tensors on the CPU
and launches the CUDA kernel (kernels/csrc/contact.cu) for tensors on a
GPU; it never falls back from one to the other. Each counts its kernel
launches in a plain integer attribute, `<wrapper>.launches`.
"""

from __future__ import annotations

import torch

TILE = 128  # row tile of the contact sweep (particles per kernel CTA)
_EPS = 1e-9
_F32 = torch.float32


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
    acc = torch.zeros((nb, tile, 4), dtype=_F32, device=dev)
    kmax = int(block_cnt.max()) if nb else 0
    for k in range(kmax):
        c = _gather_blocks(cols, block_idx, k, tile_j)
        dx, dy, dz, d2, contact = _detect(r, c, rest_dist, filter_dist,
                                          rest_filter)
        contact = contact & (block_cnt > k)[:, None, None]
        cf = contact.to(_F32)
        wi, wj = r[..., 7:8], c[:, 7:8, :]
        inv_dist = torch.rsqrt(d2 + _EPS)
        dist = d2 * inv_dist
        overlap = rest_dist - dist
        share = wi * (1.0 / (wi + wj + _EPS))
        mag = share * overlap * inv_dist * cf
        mx = (r[..., 0:1] - r[..., 3:4]) - (c[:, 0:1, :] - c[:, 3:4, :])
        my = (r[..., 1:2] - r[..., 4:5]) - (c[:, 1:2, :] - c[:, 4:5, :])
        mz = (r[..., 2:3] - r[..., 5:6]) - (c[:, 2:3, :] - c[:, 5:6, :])
        rel_n = (mx * dx + my * dy + mz * dz) * (inv_dist * inv_dist)
        tx = mx - rel_n * dx
        ty = my - rel_n * dy
        tz = mz - rel_n * dz
        inv_tnorm = torch.rsqrt(tx * tx + ty * ty + tz * tz + _EPS)
        max_slide = torch.clamp(particle_friction * overlap, min=0.0)
        fscale = torch.clamp(max_slide * inv_tnorm, max=1.0) * share * cf
        acc += torch.stack([torch.sum(dx * mag - tx * fscale, dim=2),
                            torch.sum(dy * mag - ty * fscale, dim=2),
                            torch.sum(dz * mag - tz * fscale, dim=2),
                            torch.sum(cf, dim=2)], dim=-1)
    acc = acc.view(n_pad, 4)
    return acc[:n, :3], acc[:n, 3]


def block_sparse_contact_deltas_packed(n: int, rows, cols, rest_dist,
                                       particle_friction, filter_dist,
                                       block_idx, block_cnt, tile: int = TILE,
                                       rest_filter: bool = True,
                                       tile_j: int | None = None):
    """K1: contact and friction corrections over the listed tile blocks.
    Returns (delta (n, 3), count (n,)). CPU tensors take the plain version;
    CUDA tensors launch `ag_block_sparse_contact`."""
    tile_j = tile_j or tile
    n_pad = _check_tables(rows, cols, block_idx, block_cnt, tile, tile_j)
    if rows.device.type == "cpu":
        return block_sparse_contact_plain(n, rows, cols, rest_dist,
                                          particle_friction, filter_dist,
                                          block_idx, block_cnt, tile,
                                          rest_filter, tile_j)
    _launch_device(rows)
    from adaptigraph_torch.kernels import build

    lib = build.load()
    scal = device_scalars(rows.device, rest_dist, particle_friction,
                           filter_dist)
    delta = torch.empty((n, 3), dtype=_F32, device=rows.device)
    count = torch.empty((n,), dtype=_F32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.ag_block_sparse_contact(
        *_cuda_args(rows, cols, block_idx, block_cnt, scal, delta, count),
        n, n_pad, block_idx.shape[1], tile_j, int(rest_filter), stream)
    build.check(lib, err, "ag_block_sparse_contact")
    block_sparse_contact_deltas_packed.launches += 1
    return delta, count


block_sparse_contact_deltas_packed.launches = 0


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
