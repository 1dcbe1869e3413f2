"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from adaptigraph_torch/kernels/csrc with
nvcc and drives the simulator frame through rollout_steps on three paths:
the rope at its 5,120-particle design point (2 substeps x 4 iterations, a
box pusher sweeping through the rope; K1 and K2), the granular design
point (26,982 particles in a 32,768 cap, 12 substeps x 6 iterations, the
board pushing the pile, shapes fused into the sweep; K1 with K4, and K2)
and the granular dense band (1,866 particles; K3). It holds each kernel
against its plain PyTorch version (and K1 over full lists against K3;
K2 also on its edge cases: the design point after landing, a rope
whose blocks are all pruned, and synthetic lists with empty and full
rows and stale slots), checks that two launches of each kernel on the
same inputs give the same bits, and holds frames on the card against
frames on the CPU. Each phase prints one JSON line. The last lines are
the kernel table, the card's name and power limit, and the result line
{"ok": true, "device": {...}}. Any failed phase, or the internal deadline,
exits non-zero without the result line. Without a CUDA device it fails at
once. Imports the standard library, numpy, torch and adaptigraph_torch only.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

DEVICE = "cuda:0"
DEADLINE_S = 300.0  # build plus every phase
T_MAIN = 80  # frames of the rope main-path rollout (the pusher's sweep)
T_PUSH = 30  # frames searched for the kernel checks' frame (rope meets floor)
T_GRANULAR = 36  # granular design point frames (the pile lands at about
#                  frame 7; the board, at SimEnv's speed, reaches it at
#                  about frame 6 and is 0.1 past its near face at the end)
T_LANDED = 8  # the granular design point's first frame after landing:
#               AABB lists of up to 20 blocks a row tile (as at frame 36),
#               and no granule yet within the keep distance of another
T_DENSE = 10  # dense band frames (the pile lands at about frame 7)
# the granular design point as it must come out of the builder
DESIGN = {"n_active": 26982, "cap": 32768, "tile_j": 256}
K1_ATOL = 2e-5  # tests/test_pallas_kernels.py's tolerance for the sweeps
FRAME_ATOL = 1e-4  # card vs CPU positions, 3 frames from the built scene
# card vs CPU over 3 frames with contacts (see the frame_agreement phase):
# the median particle to 1e-5, every particle to a tenth of the contact
# distance
CONTACT_MEDIAN_ATOL, CONTACT_MAX_FRAC = 1e-5, 0.1
# the granular windows with contacts: the median particle to this many
# times the CPU's own median spread under a 1e-6 nudge of its input (see
# the granular_frame_agreement phase)
GRANULAR_MEDIAN_X_NUDGED = 3.0
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_S = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations a pair costs: detection (differences, squares, sums,
# the compares) on every pair the function must test (K1 and K3 every
# listed pair, K2 the listed pairs within its keep distance: near_pairs),
# projection on every contact pair
DETECT_OPS, PROJECT_OPS = 26, 52
# float32 operations K4's stage spends on one particle against one valid
# shape, by kind (engine/state.py: 0 box, 1 capsule, 2 plane; a convex
# shape adds 12 per plane to the plane's count): the local point (18), the
# kind's distance and normal (box 31, capsule 16, plane 0), the world
# normal (15) and the contact and friction update (51). The rotation
# matrix, the same for every particle, is not counted.
SHAPE_OPS = {0: 115, 1: 100, 2: 84, 3: 84}
SHAPE_OPS_PER_PLANE = 12
# K4's shape sets (make_shapes' arguments, its slot count m_max and the
# slots the stage takes): tests/test_pallas_kernels.py's four kinds (a
# plane, a box, a capsule and a convex tetrahedron), and seven slots for
# the stage's lane split at a count that is not a multiple of its 4 lanes
# (lanes 0-2 take two shapes, lane 3 one): the four, a second box, a
# convex cube (6 planes; the tetrahedron's row is padded with 2 empty
# ones) and an invalid padding slot
TETRA = [[1, 0, 0, 0.2], [0, 1, 0, 0.2], [0, 0, 1, 0.2],
         [-0.577, -0.577, -0.577, 0.1]]
CUBE = [[1, 0, 0, 0.12], [-1, 0, 0, 0.12], [0, 1, 0, 0.12],
        [0, -1, 0, 0.12], [0, 0, 1, 0.12], [0, 0, -1, 0.12]]
FOUR_KINDS = dict(
    kinds=[2, 0, 1, 3],
    sizes=[[0, 0, 0], [0.3, 0.2, 0.3], [0.1, 0.3, 0], [0, 0, 0]],
    poses=[[0, 0, 0], [0.2, 0.15, 0.0], [-0.3, 0.2, 0.1], [0.1, 0.1, -0.2]],
    quats=[[0, 0, 0, 1], [0.1, 0.2, 0.0, 0.97], [0, 0, 0.38, 0.92],
           [0.2, 0, 0.1, 0.97]],
    planes=[None, None, None, TETRA], m_max=5, active=4)
SEVEN_SLOTS = dict(
    kinds=FOUR_KINDS["kinds"] + [0, 3],
    sizes=FOUR_KINDS["sizes"] + [[0.2, 0.1, 0.25], [0, 0, 0]],
    poses=FOUR_KINDS["poses"] + [[-0.3, 0.8, -0.3], [0.35, 0.6, 0.35]],
    quats=FOUR_KINDS["quats"] + [[0.0, 0.3, 0.1, 0.95], [0.1, 0.1, 0.0, 0.99]],
    planes=FOUR_KINDS["planes"] + [None, CUBE], m_max=8, active=7)

_phase = ["start"]


def emit(obj):
    print(json.dumps(obj), flush=True)


def watchdog():
    def fire():
        print(json.dumps({"phase": _phase[0], "ok": False,
                          "error": f"deadline of {DEADLINE_S} s passed"}),
              flush=True)
        os._exit(3)

    t = threading.Timer(DEADLINE_S, fire)
    t.daemon = True
    t.start()


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=15)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
            "nvidia-smi printed nothing: " + out.stderr.strip())
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def repeats(fn):
    """Whether two launches of fn on the same inputs give the same bits
    (the sweeps add their sums in a fixed order, with no atomics)."""
    first, second = fn(), fn()
    return all(torch.equal(x, y) for x, y in zip(first, second))


def event_ms(fn, reps, warm=3):
    """Mean device time of one call of fn, from CUDA events around reps
    back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_inputs(state, spec, tile_j, granular_groups=False):
    """The mid-push frame's inputs to K2 and K1, built as xpbd_step builds
    them: tables, AABB block lists and keep distance at the frame start,
    then the positions the first solver iteration sees (one substep of
    free flight). `granular_groups` gives every 128 particles (one row
    tile) a group of its own, as a granular scene gives every granule one,
    so that the kernels' rest_filter=False form, which the rope never
    takes, meets contacts: between tiles only, so K2 keeps a tile's
    neighbour blocks and drops its own, and its compaction reorders."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.solver import (
        frame_block_lists, pack_tables_for)

    p, prm, sh = state.particles, spec.params, state.shapes
    if granular_groups:
        grp = torch.arange(p.pos.shape[0], device=p.pos.device) // 128
        p = p._replace(group=grp.to(torch.int32))
    rows, cols = pack_tables_for(p, spec, tile_j)
    s_vel = (sh.pos - sh.prev_pos) / prm.dt
    idx, cnt, overflow, keep = frame_block_lists(p, spec, s_vel, tile_j)
    dt = prm.dt / 2
    mov = ((p.inv_mass > 0) & p.active).to(torch.float32)[:, None]
    vel = p.vel.clone()
    vel[:, 1] += prm.gravity * dt
    pred = p.pos + vel * mov * dt
    rows1, cols1 = ck.update_contact_tables(rows.clone(), cols.clone(), pred,
                                            pos_prev=p.pos)
    return dict(rows=rows, cols=cols, idx=idx, cnt=cnt, keep=keep,
                overflow=int(overflow), rows1=rows1, cols1=cols1, prm=prm,
                n=p.pos.shape[0])


def frame_contacts(state, spec):
    """Particle contacts K1 meets in the frame's first solver iteration."""
    from adaptigraph_torch.engine import contact_kernels as ck

    a = kernel_inputs(state, spec, 128)
    prm = a["prm"]
    idx, cnt = ck.refine_blocks_plain(a["rows"], a["cols"], a["keep"],
                                      prm.collide_filter_dist, a["idx"],
                                      a["cnt"])
    _, c = ck.block_sparse_contact_plain(
        a["n"], a["rows1"], a["cols1"], prm.solid_rest_distance,
        prm.particle_friction, prm.collide_filter_dist, idx, cnt)
    return int(c.sum())


def edge_block_lists(nb, nb_j, maxb, seed=0):
    """Synthetic K2 lists for nb row tiles over nb_j col blocks, numpy int32
    (block_idx (nb, maxb), block_cnt (nb,)): tile i lists no block when
    i % 3 == 0, maxb blocks when i % 3 == 1, and a count in between
    otherwise. Each row holds distinct blocks in a random order, and the
    slots at or past its count hold stale ones: K2 must carry them to the
    back in slot order and never read their blocks."""
    rng = np.random.RandomState(seed)
    idx = np.argsort(rng.rand(nb, nb_j), axis=1)[:, :maxb].astype(np.int32)
    mid = rng.randint(1, max(maxb, 2), nb)
    cnt = np.where(np.arange(nb) % 3 == 0, 0,
                   np.where(np.arange(nb) % 3 == 1, maxb, mid))
    return idx, np.minimum(cnt, maxb).astype(np.int32)


def near_pairs(rows, cols, keep_dist, block_idx, block_cnt, tile_j):
    """K2's listed pairs of two active particles closer than keep_dist, by
    the plain version's distance test: the pairs whose detection no
    culling by distance can skip, whatever the scan order. Pairs farther
    apart need no test of their own (K2 culls them by groups), so they are
    not counted in its bound."""
    from adaptigraph_torch.engine import contact_kernels as ck

    nb = block_idx.shape[0]
    r = rows.view(nb, ck.TILE, 16)
    keep = torch.as_tensor(keep_dist, dtype=torch.float32, device=rows.device)
    total = 0
    for k in range(int(block_cnt.max()) if nb else 0):
        c = ck._gather_blocks(cols, block_idx, k, tile_j)
        d2 = sum((r[..., a:a + 1] - c[:, a:a + 1, :]) ** 2 for a in range(3))
        near = ((d2 < keep * keep) & (d2 > 1e-14) & (r[..., 12:13] > 0.5)
                & (c[:, 12:13, :] > 0.5))
        total += int(near[block_cnt > k].sum())
    return total


def reset_counts():
    """Every launch count, and the unfused shape pass's call count, to 0."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.collisions import shape_contact_deltas

    k1 = ck.block_sparse_contact_deltas_packed
    k1.launches = k1.fused_launches = 0
    ck.refine_overlap_blocks_packed.launches = 0
    ck.dense_contact_deltas_packed.launches = 0
    shape_contact_deltas.calls = 0


def read_counts():
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.collisions import shape_contact_deltas

    k1 = ck.block_sparse_contact_deltas_packed
    return {"k1": k1.launches, "k4": k1.fused_launches,
            "k2": ck.refine_overlap_blocks_packed.launches,
            "k3": ck.dense_contact_deltas_packed.launches,
            "unfused_shape_pass": shape_contact_deltas.calls}


def shape_ops(shp, planes2d):
    """K4's float32 operations per particle for these shape rows (valid
    shapes only)."""
    n_planes = 0 if planes2d is None else planes2d.shape[0] // shp.shape[0]
    ops = 0
    for kind, valid in shp[:, :2].tolist():
        if valid > 0.5:
            ops += SHAPE_OPS[int(kind)] + (
                SHAPE_OPS_PER_PLANE * n_planes if int(kind) == 3 else 0)
    return ops


def bound(nbytes, ops):
    """(ms, what bounds it): the larger of bytes over the HBM rate and
    float32 operations over the float32 rate."""
    tb, to = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def shape_case(dev, tile_j, shapes=FOUR_KINDS):
    """tests/test_pallas_kernels.py's fused-stage inputs on the card: its
    256 particles against a shape set (FOUR_KINDS, its own, or
    SEVEN_SLOTS): (rows, cols, block lists, shp, planes2d,
    shape_params)."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.state import make_shapes

    rng = np.random.RandomState(3)
    n = 256
    pos = (rng.rand(n, 3).astype(np.float32) * 1.2
           - np.array([0.6, 0.0, 0.6], np.float32))
    prev = pos - rng.randn(n, 3).astype(np.float32) * 0.01
    sh = make_shapes(shapes["kinds"], shapes["sizes"], shapes["poses"],
                     shapes["quats"], m_max=shapes["m_max"],
                     planes=shapes["planes"], device=dev)
    s_vel = torch.as_tensor(
        rng.randn(shapes["m_max"], 3).astype(np.float32) * 0.05, device=dev)
    a = shapes["active"]
    shp = torch.cat([sh.kind[:a, None].float(), sh.valid[:a, None].float(),
                     sh.size[:a], sh.pos[:a], sh.quat[:a], s_vel[:a],
                     torch.zeros((a, 1), device=dev)], 1).contiguous()
    planes2d = sh.planes[:a].reshape(-1, 4).contiguous()

    def t(x):
        return torch.as_tensor(x, device=dev)

    rows, cols = ck.pack_contact_tables(
        t(pos), t(prev), t((np.arange(n) // 16).astype(np.int32)),
        t(np.ones(n, np.float32)), t(np.zeros(n, bool)), t(np.ones(n, bool)),
        t(rng.rand(n, 3).astype(np.float32)), tile_j=tile_j)
    n_pad = cols.shape[1]
    idx, cnt, _ = ck.tile_overlap_blocks(
        cols[0:3].T.contiguous(), cols[12] > 0.5,
        torch.tensor(0.05 * 1.5, device=dev), tile_j=tile_j)
    return dict(n=n, n_pad=n_pad, rows=rows, cols=cols, idx=idx, cnt=cnt,
                shp=shp, planes2d=planes2d, scal=(0.05, 0.25, 0.0),
                shape_params=(0.04, 0.0, 0.3, 1.0 / 60))


def fused_vs_unfused(a, rest_filter, tile_j):
    """Fused K1 (K4) against the unfused K1 plus shape_stage_plain on the
    same inputs, and the unfused K1 against its plain version (the fused
    and unfused launches share the pair sweep, so only the plain version
    can catch a fault in it). Returns the report (counts equal, max |delta
    error| of each comparison, particle and shape contacts)."""
    from adaptigraph_torch.engine import contact_kernels as ck

    n = a["n"]
    args = (n, a["rows"], a["cols"], *a["scal"], a["idx"], a["cnt"])
    kw = dict(rest_filter=rest_filter, tile_j=tile_j)
    d1, c1 = ck.block_sparse_contact_deltas_packed(
        *args, shp=a["shp"], planes2d=a["planes2d"],
        shape_params=a["shape_params"], **kw)
    d0, c0 = ck.block_sparse_contact_deltas_packed(*args, **kw)
    fused_again = repeats(lambda: ck.block_sparse_contact_deltas_packed(
        *args, shp=a["shp"], planes2d=a["planes2d"],
        shape_params=a["shape_params"], **kw))
    unfused_again = repeats(
        lambda: ck.block_sparse_contact_deltas_packed(*args, **kw))
    pd, pc = ck.block_sparse_contact_plain(*args, **kw)
    ds, cs = ck.shape_stage_plain(a["rows"][:n, 0:3], a["rows"][:n, 3:6],
                                  a["shp"], a["planes2d"], *a["shape_params"])
    per_shape = []
    for k in range(a["shp"].shape[0]):
        pl = (None if a["planes2d"] is None else
              a["planes2d"].view(a["shp"].shape[0], -1, 4)[k])
        per_shape.append(int(ck.shape_stage_plain(
            a["rows"][:n, 0:3], a["rows"][:n, 3:6], a["shp"][k:k + 1], pl,
            *a["shape_params"])[1].sum()))
    return {"tile_j": tile_j, "rest_filter": rest_filter,
            "counts_equal": bool(torch.equal(c1, c0 + cs)),
            "max_abs_err": float((d1 - (d0 + ds)).abs().max()),
            "k1_counts_equal": bool(torch.equal(c0, pc)),
            "k1_max_abs_err": float((d0 - pd).abs().max()),
            "particle_contacts": int(pc.sum()),
            "shape_contacts": int(cs.sum()),
            "shape_contacts_by_slot": per_shape,
            "valid_slots": [v > 0.5 for v in a["shp"][:, 1].tolist()],
            "fused_repeats_bitwise": fused_again,
            "unfused_repeats_bitwise": unfused_again,
            "finite": bool(torch.isfinite(d1).all())}


def k2_edges(cases):
    """K2 on the card against refine_blocks_plain, `torch.equal` on lists
    and counts, and two launches for equal bits, over `cases`: (name, K2's
    inputs (rows, cols, keep_dist, filter_dist, block_idx, block_cnt),
    tile_j, rest_filter). Returns the report of each case."""
    from adaptigraph_torch.engine import contact_kernels as ck

    report = []
    for name, args, tile_j, rf in cases:
        kw = dict(rest_filter=rf, tile_j=tile_j)
        n = args[0].shape[0]
        ki, kc = ck.refine_overlap_blocks_packed(n, *args, **kw)
        pi, pc = ck.refine_blocks_plain(*args, **kw)
        cnt, maxb = args[5], args[4].shape[1]
        report.append({
            "case": name, "tile_j": tile_j, "rest_filter": rf,
            "equal": bool(torch.equal(ki, pi) and torch.equal(kc, pc)),
            "repeats_bitwise": repeats(
                lambda: ck.refine_overlap_blocks_packed(n, *args, **kw)),
            "row_tiles": int(cnt.shape[0]), "maxb": maxb,
            "tiles_listing_none": int((cnt == 0).sum()),
            "tiles_listing_maxb": int((cnt == maxb).sum()),
            "listed": int(cnt.sum()), "max_blocks_per_tile": int(cnt.max()),
            "kept": int(pc.sum())})
    return report


def granular_phases(dev, lib):
    """The granular design point and its dense band on the card. Returns
    what the kernel table needs: launches, errors, times and bounds."""
    from adaptigraph_torch.engine import contact_kernels as ck
    from adaptigraph_torch.engine.collisions import (
        shape_contact_deltas, shape_sdf)
    from adaptigraph_torch.engine.solver import (
        _shape_table, auto_contact_mode, auto_tile_j, frame_block_lists,
        pack_tables_for, rollout_steps)
    from adaptigraph_torch.engine.state import tree_to
    from adaptigraph_torch.kernels import build
    from adaptigraph_torch.scenes import design_point as dp

    out = {}
    # the design point, built as SimEnv builds it
    _phase[0] = "granular_scene"
    t0 = time.perf_counter()
    g = dp.granular_scene(device=dev)
    gp, spec = g.state.particles, g.spec
    n = gp.pos.shape[0]
    # SimEnv's rule: no self-colliding particle, no rest filter
    rest_filter = bool(gp.self_collide[: g.n_active].any())
    tj = auto_tile_j(n)
    s_vel0 = (g.state.shapes.pos - g.state.shapes.prev_pos) / spec.params.dt
    idx0, cnt0, ov0, _ = frame_block_lists(gp, spec, s_vel0, tj)
    n_shapes = int(g.state.shapes.kind.shape[0])  # SimEnv's caps.m
    caps = {"n": n, "c": int(spec.clusters.member.shape[0]),
            "k": int(spec.clusters.member.shape[1]), "m": n_shapes}
    info = {"phase": "granular_scene", "n_active": g.n_active, "caps": caps,
            "granules": int(spec.clusters.valid.sum()),
            "contact_mode": auto_contact_mode(n), "tile_j": tj,
            "rest_filter": rest_filter, "maxb": int(idx0.shape[1]),
            "row_tiles": int(idx0.shape[0]),
            "listed_blocks": int(cnt0.sum()),
            "max_blocks_per_tile": int(cnt0.max()), "overflow": int(ov0),
            "segments": spec.cluster_seg is not None,
            "substeps": g.substeps, "iterations": g.iterations,
            "seconds": time.perf_counter() - t0}
    ok = (g.n_active == DESIGN["n_active"] and n == DESIGN["cap"]
          and tj == DESIGN["tile_j"]
          and not rest_filter and int(ov0) == 0
          and spec.cluster_seg is not None)
    emit({**info, "ok": ok})
    if not ok:
        raise RuntimeError("the granular design point is not as expected")

    # the main path: rollout_steps with the shapes fused into the sweep
    _phase[0] = "granular_path"
    ptj, qtj = dp.board_sweep(g, T_GRANULAR)
    kw = dict(rest_filter=rest_filter, n_shapes_active=n_shapes)
    rollout_steps(g.state, spec, ptj[:2], qtj[:2], g.substeps, g.iterations,
                  record=False, **kw)  # warm-up

    def path():  # in two calls, to keep the state of the landed frame
        landed, _ = rollout_steps(g.state, spec, ptj[:T_LANDED],
                                  qtj[:T_LANDED], g.substeps, g.iterations,
                                  record=False, **kw)
        return landed, rollout_steps(
            landed, spec, ptj[T_LANDED:], qtj[T_LANDED:], g.substeps,
            g.iterations, record=False, **kw)[0]

    reset_counts()
    (landed, final), secs = sync_time(path)
    counts = read_counts()
    fp = final.particles
    act = fp.active
    sd, _ = shape_sdf(fp.pos[act], final.shapes.kind, final.shapes.size,
                      final.shapes.pos, final.shapes.quat)
    board_touching = int((sd[3] < spec.params.collision_distance).sum())
    # the board meets the pile: particles it pushed along +z
    pushed = int(((fp.pos - gp.pos)[act][:, 2] > 0.05).sum())
    iters = g.substeps * g.iterations
    overflow = int(final.contact_overflow)
    finite = bool(torch.isfinite(fp.pos).all())
    emit({"phase": "granular_path", "frames": T_GRANULAR, "seconds": secs,
          "frames_per_s": T_GRANULAR / secs,
          "ms_per_frame": 1e3 * secs / T_GRANULAR, "launches": counts,
          "launches_per_frame": {k: v / T_GRANULAR
                                 for k, v in counts.items()},
          "contact_overflow": overflow, "finite": finite,
          "particles_touching_board": board_touching,
          "particles_pushed_0.05_along_z": pushed,
          "max_displacement": float((fp.pos - gp.pos).abs().max())})
    if (counts["k1"] != iters * T_GRANULAR or counts["k4"] != counts["k1"]
            or counts["k2"] != T_GRANULAR or counts["k3"] != 0
            or counts["unfused_shape_pass"] != 0 or overflow != 0
            or not finite or pushed == 0):
        raise RuntimeError("granular main path check failed")
    out["granular_counts"] = counts
    la = kernel_inputs(landed, spec, tj)
    out["k2_landed_args"] = (la["rows"], la["cols"], la["keep"],
                             spec.params.collide_filter_dist, la["idx"],
                             la["cnt"])

    # K4: fused K1 against the unfused K1 plus shape_stage_plain
    _phase[0] = "k4_check"
    cases, k4_err = [], 0.0
    for (name, shapes), tile_j, rf in itertools.product(
            (("four_kinds", FOUR_KINDS), ("seven_slots", SEVEN_SLOTS)),
            (128, 256), (True, False)):
        r = fused_vs_unfused(shape_case(dev, tile_j, shapes), rf, tile_j)
        cases.append({"scene": name, **r})
    # the design point's last frame: the pile on the table, the board in
    # it; K2 on the card against its plain version on the frame's lists
    prm = spec.params
    sh = final.shapes
    s_vel = (sh.pos - sh.prev_pos) / prm.dt
    rows, cols = pack_tables_for(fp, spec, tj)
    idx, cnt, _, keep = frame_block_lists(fp, spec, s_vel, tj)
    k2_args = (rows, cols, keep, prm.collide_filter_dist, idx, cnt)
    ridx, rcnt = ck.refine_blocks_plain(*k2_args, rest_filter=rest_filter,
                                        tile_j=tj)
    kidx, kcnt = ck.refine_overlap_blocks_packed(
        n, *k2_args, rest_filter=rest_filter, tile_j=tj)
    k2_case = {"scene": "granular_design_point", "tile_j": tj,
               "rest_filter": rest_filter, "keep_dist": float(keep),
               "equal": bool(torch.equal(kidx, ridx)
                             and torch.equal(kcnt, rcnt)),
               "listed": int(cnt.sum()), "kept": int(rcnt.sum()),
               "max_blocks_per_tile": int(rcnt.max())}
    # the shape table of the frame's last substep (s_pos = pos), packed as
    # the solver packs it, with the frame's shape velocity
    shp, planes2d = _shape_table(sh, sh.pos, sh.quat, s_vel, n_shapes)
    gcase = dict(n=n, rows=rows, cols=cols, idx=ridx, cnt=rcnt, shp=shp,
                 k2_args=k2_args,
                 planes2d=planes2d,
                 scal=(prm.solid_rest_distance, prm.particle_friction,
                       prm.collide_filter_dist),
                 shape_params=(prm.collision_distance,
                               prm.shape_collision_margin,
                               prm.dynamic_friction, prm.dt / g.substeps))
    cases.append({"scene": "granular_design_point",
                  **fused_vs_unfused(gcase, rest_filter, tj)})
    for c in cases:
        k4_err = max(k4_err, c["max_abs_err"])
    # on the shape sets every valid slot meets particles, and an invalid
    # one none
    sets = [c for c in cases if c["scene"] != "granular_design_point"]
    k1_err = max(c["k1_max_abs_err"] for c in cases)
    ok = (all(c["counts_equal"] and c["max_abs_err"] <= K1_ATOL
              and c["k1_counts_equal"] and c["k1_max_abs_err"] <= K1_ATOL
              and c["finite"] and c["shape_contacts"] > 0
              and c["fused_repeats_bitwise"] and c["unfused_repeats_bitwise"]
              for c in cases)
          and all((n > 0) == v for c in sets for n, v in zip(
              c["shape_contacts_by_slot"], c["valid_slots"]))
          and cases[-1]["particle_contacts"] > 0 and k2_case["equal"])
    emit({"phase": "k4_check", "ok": ok, "atol": K1_ATOL, "cases": cases,
          "k2_case": k2_case})
    if not ok:
        raise RuntimeError("K4 check failed")
    out["k4_err"] = k4_err
    out["k1_err"] = k1_err
    out["k2_equal"] = k2_case["equal"]
    k1_contacts = cases[-1]["particle_contacts"]
    out["k4_case"] = gcase

    # the dense band through the same entry point, auto contact mode
    _phase[0] = "granular_dense_path"
    d = dp.granular_dense_point(dev)
    dspec = d.spec
    dn = d.state.particles.pos.shape[0]
    dtj, dqj = dp.board_sweep(d, T_DENSE + 3)
    rollout_steps(d.state, dspec, dtj[:1], dqj[:1], d.substeps, d.iterations,
                  record=False)  # warm-up
    reset_counts()
    (dfinal, drec), dsecs = sync_time(lambda: rollout_steps(
        d.state, dspec, dtj[:T_DENSE], dqj[:T_DENSE], d.substeps,
        d.iterations))
    dcounts = read_counts()
    dfinite = bool(torch.isfinite(drec).all())
    emit({"phase": "granular_dense_path", "n_active": d.n_active,
          "cap": dn, "contact_mode": auto_contact_mode(dn),
          "frames": T_DENSE, "seconds": dsecs,
          "frames_per_s": T_DENSE / dsecs,
          "ms_per_frame": 1e3 * dsecs / T_DENSE, "launches": dcounts,
          "finite": dfinite,
          "max_displacement": float(
              (drec[-1] - d.state.particles.pos).abs().max())})
    if (dcounts["k3"] != d.substeps * d.iterations * T_DENSE
            or dcounts["k1"] != 0 or dcounts["k2"] != 0 or not dfinite):
        raise RuntimeError("granular dense path check failed")
    out["dense_counts"] = dcounts

    # K3 against its plain version: frames of the dense path before and
    # after the pile lands, and the built scene with each granule moved
    # 0.07 x its index back along z so that neighbours overlap
    _phase[0] = "k3_check"
    dp_ = d.state.particles
    dprm = dspec.params
    pressed = dp_.pos.clone()
    pressed[:, 2] -= 0.07 * dp_.group.clamp(min=0).float()
    frames = [("built", dp_.pos, dp_.pos), ("pressed", pressed, dp_.pos)]
    for t in (2, T_DENSE // 2, T_DENSE - 1):
        frames.append((f"frame_{t}", drec[t], drec[t - 1]))
    k3_cases, k3_err, k3_best = [], 0.0, None
    for name, pos, prev in frames:
        rows, cols = ck.pack_contact_tables(
            pos, prev, dp_.group, dp_.inv_mass, dp_.self_collide,
            dp_.active, dspec.rest_pos)
        args = (dn, rows, cols, dprm.solid_rest_distance,
                dprm.particle_friction, dprm.collide_filter_dist)
        kd, kc = ck.dense_contact_deltas_packed(*args)
        pd, pc = ck.dense_contact_plain(*args)
        err = float((kd - pd).abs().max())
        case = {"frame": name, "counts_equal": bool(torch.equal(kc, pc)),
                "max_abs_err": err, "contacts": int(pc.sum()),
                "repeats_bitwise": repeats(
                    lambda args=args: ck.dense_contact_deltas_packed(*args)),
                "finite": bool(torch.isfinite(kd).all())}
        k3_cases.append(case)
        k3_err = max(k3_err, err)
        if k3_best is None or case["contacts"] > k3_best[0]:
            k3_best = (case["contacts"], args)
    ok = (all(c["counts_equal"] and c["max_abs_err"] <= K1_ATOL
              and c["finite"] and c["repeats_bitwise"] for c in k3_cases)
          and any(c["contacts"] > 0 for c in k3_cases))
    emit({"phase": "k3_check", "ok": ok, "atol": K1_ATOL, "cases": k3_cases})
    if not ok:
        raise RuntimeError("K3 check failed")
    out["k3_err"] = k3_err
    out["k3_args"] = k3_best[1]

    # K1 over the dense band's frame with the most contacts, every col block
    # listed for every row tile (rest filter on, tile_j 128), so that every
    # cluster rank of every tile has slots: against K3 and against the
    # plain version on the same tables
    _phase[0] = "k1_full_list"
    fcols = k3_best[1][2]
    nbf = fcols.shape[1] // ck.TILE
    full_idx = torch.arange(nbf, dtype=torch.int32, device=dev).repeat(nbf, 1)
    full_cnt = torch.full((nbf,), nbf, dtype=torch.int32, device=dev)
    fargs = (*k3_best[1], full_idx, full_cnt)
    fd, fc = ck.block_sparse_contact_deltas_packed(*fargs, tile_j=ck.TILE)
    kd3, kc3 = ck.dense_contact_deltas_packed(*k3_best[1])
    pdf, pcf = ck.block_sparse_contact_plain(*fargs, tile_j=ck.TILE)
    geo = build.launch_geometry(lib, "k1", fcols.shape[1], nbf)
    full = {"phase": "k1_full_list", "row_tiles": nbf, "slots": nbf,
            "geometry": geo, "contacts": int(pcf.sum()),
            "counts_equal_k3": bool(torch.equal(fc, kc3)),
            "max_abs_err_k3": float((fd - kd3).abs().max()),
            "counts_equal_plain": bool(torch.equal(fc, pcf)),
            "max_abs_err_plain": float((fd - pdf).abs().max()),
            "repeats_bitwise": repeats(
                lambda: ck.block_sparse_contact_deltas_packed(
                    *fargs, tile_j=ck.TILE))}
    full["ok"] = (full["counts_equal_k3"] and full["counts_equal_plain"]
                  and full["max_abs_err_k3"] <= K1_ATOL
                  and full["max_abs_err_plain"] <= K1_ATOL
                  and full["repeats_bitwise"] and full["contacts"] > 0
                  and nbf >= geo["cluster"])
    emit({**full, "atol": K1_ATOL})
    if not full["ok"]:
        raise RuntimeError("K1 over full lists disagrees")
    out["k1_full_err"] = full["max_abs_err_plain"]

    # card against CPU, 3 frames from the same state, on the dense band and
    # on a block-mode granular scene small enough for the CPU (RandomState
    # 11 in its 4,096 bucket) in the design point's forms: fused shapes,
    # tile_j 256, no rest filter. The free-fall window (from the built
    # scene) is held to FRAME_ATOL. The window with contacts (the pile on
    # the table, the board at it) is held in bulk and tail: a granule's
    # shape matching is over-relaxed 72 times a frame and the velocity
    # update multiplies position rounding by 720, so a 1e-6 nudge of the
    # CPU's own input moves its output by a median of ~1e-5
    # (tests/test_torch_granular.py); the median particle to
    # GRANULAR_MEDIAN_X_NUDGED times that nudged median, measured here on
    # the same window, and every particle to CONTACT_MAX_FRAC of the
    # contact distance.
    _phase[0] = "granular_frame_agreement"
    b11 = dp.granular_scene(11, device=dev)
    btj, bqj = dp.board_sweep(b11, T_DENSE + 3)
    scenes = (("dense_band", d, dtj, dqj, {}, dfinal),
              ("block_fused_seed11", b11, btj, bqj,
               dict(contact_mode="block", rest_filter=False,
                    contact_tile_j=DESIGN["tile_j"],
                    n_shapes_active=int(b11.state.shapes.kind.shape[0])),
               None))
    report, failed = {}, []
    for name, sb, ptraj, qtraj, kw, at_window in scenes:
        spec_cpu = tree_to(sb.spec, "cpu")

        def three(state, start, device, sb=sb, ptraj=ptraj, qtraj=qtraj,
                  kw=kw, spec_cpu=spec_cpu):
            sl = slice(start, start + 3)
            fin, rec = rollout_steps(
                tree_to(state, device),
                sb.spec if device != "cpu" else spec_cpu, ptraj[sl],
                qtraj[sl], sb.substeps, sb.iterations, **kw)
            return rec.cpu(), int(fin.contact_overflow)

        t0 = time.perf_counter()
        card0, og = three(sb.state, 0, dev)
        c0, oc = three(sb.state, 0, "cpu")
        free = float((card0 - c0).abs().max())
        if at_window is None:
            at_window, _ = rollout_steps(sb.state, sb.spec, ptraj[:T_DENSE],
                                         qtraj[:T_DENSE], sb.substeps,
                                         sb.iterations, record=False, **kw)
        card, _ = three(at_window, T_DENSE, dev)
        c, oc2 = three(at_window, T_DENSE, "cpu")
        noise = np.random.RandomState(1).randn(
            *at_window.particles.pos.shape)
        nudged = at_window._replace(particles=at_window.particles._replace(
            pos=at_window.particles.pos + torch.as_tensor(
                noise * 1e-6, dtype=torch.float32, device=dev)))
        cn, _ = three(nudged, T_DENSE, "cpu")
        per_particle = (card - c).abs().amax(dim=(0, 2))
        spread = (cn - c).abs().amax(dim=(0, 2))
        max_diff = float(CONTACT_MAX_FRAC
                         * sb.spec.params.solid_rest_distance)
        sp = sb.spec.params
        act = at_window.particles.active.cpu()
        last = c[-1]
        rows, cols = ck.pack_contact_tables(
            last, last, *(t.cpu() for t in (
                at_window.particles.group, at_window.particles.inv_mass,
                at_window.particles.self_collide, at_window.particles.active,
                sb.spec.rest_pos)))
        _, pc = ck.dense_contact_plain(last.shape[0], rows, cols,
                                       sp.solid_rest_distance.cpu(),
                                       sp.particle_friction.cpu(),
                                       sp.collide_filter_dist.cpu())
        r = report[name] = {
            "n_active": sb.n_active, "mode": kw.get("contact_mode", "auto"),
            "free_fall_frames_0_2": {
                "card_vs_cpu_max": free, "overflow": [og, oc],
                "max_displacement": float(
                    (c0[-1] - sb.state.particles.pos.cpu()).abs().max())},
            f"contact_frames_{T_DENSE}_{T_DENSE + 2}": {
                "card_vs_cpu_max": float(per_particle.max()),
                "card_vs_cpu_median": float(per_particle.median()),
                "cpu_vs_cpu_nudged_1e-6_max": float(spread.max()),
                "cpu_vs_cpu_nudged_1e-6_median": float(spread.median()),
                "particle_contacts_at_end": int(pc.sum()),
                "overflow": oc2,
                "max_displacement": float(
                    (last - at_window.particles.pos.cpu())[act]
                    .abs().max())},
            "seconds": time.perf_counter() - t0}
        if not free <= FRAME_ATOL:
            failed.append(f"{name} free fall")
        median_atol = GRANULAR_MEDIAN_X_NUDGED * float(spread.median())
        r[f"contact_frames_{T_DENSE}_{T_DENSE + 2}"]["median_atol"] = (
            median_atol)
        if not (float(per_particle.median()) <= median_atol
                and float(per_particle.max()) <= max_diff):
            failed.append(f"{name} contact window")
    emit({"phase": "granular_frame_agreement", "frames": 3,
          "free_fall_atol": FRAME_ATOL,
          "contact_median_atol": f"{GRANULAR_MEDIAN_X_NUDGED} x the nudged "
                                 f"median",
          "contact_max_atol": float(CONTACT_MAX_FRAC * 0.03), **report})
    if failed:
        raise RuntimeError(f"card and CPU granular frames disagree in "
                           f"{failed}")

    # kernel times at the granular shapes (K3, K4; K1 and K2 at the design
    # point's last frame)
    _phase[0] = "kernel_times"
    stream = torch.cuda.current_stream().cuda_stream
    dn_, drows, dcols = k3_best[1][:3]
    dn_pad = dcols.shape[1]
    s3 = ck.device_scalars(dev, *k3_best[1][3:])
    delta3 = torch.empty((dn_, 3), device=dev)
    count3 = torch.empty((dn_,), device=dev)
    k3_ptrs = [t.data_ptr() for t in (drows, dcols, s3, delta3, count3)]

    def k3_raw():
        build.check(lib, lib.ag_dense_contact(*k3_ptrs, dn_, dn_pad, stream),
                    "K3")

    a = gcase
    n_pad = a["cols"].shape[1]
    empty_cnt = torch.zeros_like(a["cnt"])
    s4 = ck.device_scalars(dev, *a["scal"], *a["shape_params"])
    delta4 = torch.empty((n, 3), device=dev)
    count4 = torch.empty((n,), device=dev)
    n_pl = 0 if a["planes2d"] is None else a["planes2d"].shape[0] // n_shapes
    planes_ptr = None if a["planes2d"] is None else a["planes2d"].data_ptr()

    def k4_raw(block_cnt):
        ptrs = [t.data_ptr() for t in (a["rows"], a["cols"], a["idx"],
                                       block_cnt, s4, a["shp"])]
        build.check(lib, lib.ag_block_sparse_contact_shapes(
            *ptrs, planes_ptr, delta4.data_ptr(), count4.data_ptr(), n,
            n_pad, a["idx"].shape[1], tj, int(rest_filter), n_shapes, n_pl,
            stream), "K4")

    s1 = ck.device_scalars(dev, *a["scal"])
    maxb = a["idx"].shape[1]

    def k1_raw(block_cnt):
        ptrs = [t.data_ptr() for t in (a["rows"], a["cols"], a["idx"],
                                       block_cnt, s1, delta4, count4)]
        build.check(lib, lib.ag_block_sparse_contact(
            *ptrs, n, n_pad, maxb, tj, int(rest_filter), stream), "K1")

    def k2_raw(k2_args):
        s2 = ck.device_scalars(dev, k2_args[2], k2_args[3])
        new_idx = torch.empty_like(k2_args[4])
        new_cnt = torch.empty_like(k2_args[5])

        def launch():  # holds the scalars and outputs while it is timed
            ptrs = [t.data_ptr() for t in (*k2_args[:2], *k2_args[4:], s2,
                                           new_idx, new_cnt)]
            build.check(lib, lib.ag_refine_blocks(
                *ptrs, n_pad, k2_args[4].shape[1], tj, int(rest_filter),
                stream), "K2")
        return launch

    # K2 at the design point's last frame, and at its first frame after
    # landing
    k2_args, k2_landed = a["k2_args"], out["k2_landed_args"]
    k2_last, k2_land = k2_raw(k2_args), k2_raw(k2_landed)

    k1_args = (n, a["rows"], a["cols"], *a["scal"], a["idx"], a["cnt"])
    k1_kw = dict(rest_filter=rest_filter, tile_j=tj)

    pos_i, prev_i = a["rows"][:n, 0:3], a["rows"][:n, 3:6]
    unfused = (pos_i, prev_i, sh, sh.pos, sh.quat, s_vel,
               prm.collision_distance, prm.shape_collision_margin,
               prm.dynamic_friction, prm.dt / g.substeps)
    plain4 = (pos_i, prev_i, a["shp"], a["planes2d"], *a["shape_params"])
    times = {
        "k3_plain_a": event_ms(lambda: ck.dense_contact_plain(*k3_best[1]), 5),
        "k3": event_ms(k3_raw, 100),
        "k3_b": event_ms(k3_raw, 100),
        "k3_plain_b": event_ms(lambda: ck.dense_contact_plain(*k3_best[1]), 5),
        "k4_plain_a": event_ms(lambda: ck.shape_stage_plain(*plain4), 10),
        # K4 alone (the fused launch over empty lists) beside the unfused
        # launch over the same empty lists, the floor it stands on
        "k1_empty": event_ms(lambda: k1_raw(empty_cnt), 200),
        "k4_alone": event_ms(lambda: k4_raw(empty_cnt), 200),
        "k4_alone_b": event_ms(lambda: k4_raw(empty_cnt), 200),
        "k1_empty_b": event_ms(lambda: k1_raw(empty_cnt), 200),
        "k4_plain_b": event_ms(lambda: ck.shape_stage_plain(*plain4), 10),
        "unfused_shape_pass_a": event_ms(
            lambda: shape_contact_deltas(*unfused), 20),
        "unfused_shape_pass_b": event_ms(
            lambda: shape_contact_deltas(*unfused), 20),
        "k1_granular_plain_a": event_ms(
            lambda: ck.block_sparse_contact_plain(*k1_args, **k1_kw), 3),
        "k1_granular": event_ms(lambda: k1_raw(a["cnt"]), 100),
        "k1_granular_b": event_ms(lambda: k1_raw(a["cnt"]), 100),
        "k1_granular_plain_b": event_ms(
            lambda: ck.block_sparse_contact_plain(*k1_args, **k1_kw), 3),
        "k1_fused_granular": event_ms(lambda: k4_raw(a["cnt"]), 100),
        "k1_fused_granular_b": event_ms(lambda: k4_raw(a["cnt"]), 100),
        "k2_granular_plain_a": event_ms(
            lambda: ck.refine_blocks_plain(*k2_args, **k1_kw), 3),
        "k2_granular": event_ms(k2_last, 100),
        "k2_granular_b": event_ms(k2_last, 100),
        "k2_granular_plain_b": event_ms(
            lambda: ck.refine_blocks_plain(*k2_args, **k1_kw), 3),
        "k2_landed_plain_a": event_ms(
            lambda: ck.refine_blocks_plain(*k2_landed, **k1_kw), 3),
        "k2_landed": event_ms(k2_land, 100),
        "k2_landed_b": event_ms(k2_land, 100),
        "k2_landed_plain_b": event_ms(
            lambda: ck.refine_blocks_plain(*k2_landed, **k1_kw), 3),
    }
    _, pc3 = ck.dense_contact_plain(*k3_best[1])
    contacts3 = int(pc3.sum())
    # the function's pairs: every pair of the dense band's active particles
    # (the padded rows and columns are inactive and never in contact)
    pairs3 = d.n_active * d.n_active
    k3_bytes = 2 * dn_pad * 16 * 4 + 3 * 4 + dn_ * 4 * 4
    k3_ops = DETECT_OPS * pairs3 + PROJECT_OPS * contacts3
    # K1 and K2 at the design point, counted as at the rope point: K1's
    # detection on every listed pair and projection on each contact; K2's
    # detection on the listed pairs within its keep distance (near_pairs)
    nb = a["idx"].shape[0]
    table_bytes = 2 * n_pad * 16 * 4
    list_bytes = (nb * maxb + nb) * 4
    pairs1 = int(a["cnt"].sum()) * ck.TILE * tj
    k1_bytes = table_bytes + list_bytes + 3 * 4 + n * 4 * 4
    k1_ops = DETECT_OPS * pairs1 + PROJECT_OPS * k1_contacts
    k2_bytes = table_bytes + 2 * list_bytes + 2 * 4
    pairs2 = int(k2_args[5].sum()) * ck.TILE * tj
    pairs2_landed = int(k2_landed[5].sum()) * ck.TILE * tj
    near2 = near_pairs(*k2_args[:3], *k2_args[4:], tj)
    near2_landed = near_pairs(*k2_landed[:3], *k2_landed[4:], tj)
    per_particle_ops = shape_ops(a["shp"], a["planes2d"])
    k4_bytes = n * 6 * 4 + n * 4 * 4 + a["shp"].numel() * 4
    k4_ops = n * per_particle_ops
    out["k1_bound"] = bound(k1_bytes, k1_ops)
    out["k2_bound"] = bound(k2_bytes, DETECT_OPS * near2)
    out["k2_landed_bound"] = bound(k2_bytes, DETECT_OPS * near2_landed)
    out["k3_bound"] = bound(k3_bytes, k3_ops)
    out["k4_bound"] = bound(k4_bytes, k4_ops)
    out["times"] = times
    out["geometry"] = {
        "k1_granular": build.launch_geometry(lib, "k1", n_pad, maxb),
        "k3": build.launch_geometry(lib, "k3", dn_pad),
        "k2_granular": build.launch_geometry(lib, "k2", n_pad,
                                             k2_args[4].shape[1])}
    out["detail"] = {
        "k3": {"n": dn_, "n_active": d.n_active, "n_pad": dn_pad,
               "pairs": pairs3,
               "contacts": contacts3, "bytes": k3_bytes, "ops": k3_ops},
        "k4": {"n": n, "valid_shapes": int((a["shp"][:, 1] > 0.5).sum()),
               "shape_rows": n_shapes, "ops_per_particle": per_particle_ops,
               "bytes": k4_bytes, "ops": k4_ops,
               "timed_as": "fused launch over empty block lists, less the "
                           "unfused launch over the same lists"},
        "k1_granular": {"tile_j": tj, "rest_filter": rest_filter,
                        "listed_blocks": int(a["cnt"].sum()),
                        "pairs": pairs1, "contacts": k1_contacts,
                        "bytes": k1_bytes, "ops": k1_ops},
        "k2_granular": {"listed_blocks": int(k2_args[5].sum()),
                        "max_blocks_per_tile": int(k2_args[5].max()),
                        "listed_pairs": pairs2, "near_pairs": near2,
                        "bytes": k2_bytes, "ops": DETECT_OPS * near2},
        "k2_landed": {"frame": T_LANDED,
                      "listed_blocks": int(k2_landed[5].sum()),
                      "max_blocks_per_tile": int(k2_landed[5].max()),
                      "listed_pairs": pairs2_landed,
                      "near_pairs": near2_landed, "bytes": k2_bytes,
                      "ops": DETECT_OPS * near2_landed}}
    return out


def main():
    watchdog()
    t_start = time.perf_counter()

    _phase[0] = "device"
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    dev = torch.device(DEVICE)
    torch.cuda.set_device(0)

    import adaptigraph_torch.engine.contact_kernels as ck
    from adaptigraph_torch.engine.solver import rollout_steps
    from adaptigraph_torch.engine.state import tree_to
    from adaptigraph_torch.kernels import build
    from adaptigraph_torch.scenes.design_point import (
        pusher_sweep, rope_design_point)

    _phase[0] = "build"
    t0 = time.perf_counter()
    log = build.build(timeout=240)
    lib = build.load()
    ptxas = [ln.strip() for ln in (log or "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "compiled": log is not None, "ptxas": ptxas})

    _phase[0] = "scene"
    t0 = time.perf_counter()
    b = rope_design_point(dev)
    spec = b.spec
    pos_traj, quat_traj = pusher_sweep(b, T_MAIN)
    # the kernel checks need a frame with particle contacts: step the first
    # T_PUSH frames one at a time and take the frame whose first solver
    # iteration meets the most (a sweep with no contacts proves nothing)
    st, found = b.state, []
    for t in range(T_PUSH):
        st, _ = rollout_steps(st, spec, pos_traj[t:t + 1], quat_traj[t:t + 1],
                              b.substeps, b.iterations, record=False)
        found.append((frame_contacts(st, spec), t, st))
    best, t_check, pushed = max(found, key=lambda f: (f[0], -f[1]))
    by_frame = [f[0] for f in found]
    # the state one frame before the first frame with contacts, for the
    # frame-agreement window across the contact onset
    t_on = next((t for t, c in enumerate(by_frame) if c > 0), t_check)
    before_onset = found[t_on - 1][2] if t_on > 0 else b.state
    del found
    torch.cuda.synchronize()
    movable = int(((b.state.particles.inv_mass > 0)
                   & b.state.particles.active).sum())
    emit({"phase": "scene", "ok": True, "n_active": b.n_active,
          "movable": movable, "clusters": int(spec.clusters.valid.sum()),
          "substeps": b.substeps, "iterations": b.iterations,
          "searched_frames": T_PUSH, "check_frame": t_check,
          "check_frame_contacts": best, "contacts_by_frame": by_frame,
          "seconds": time.perf_counter() - t0})
    if movable == 0:
        raise RuntimeError("every particle is pinned")

    # K2 against its plain version: the block lists must be equal in full.
    # On the check frame K2 keeps every listed block (contacts everywhere,
    # and the moving pusher widens the keep distance to its cap); on the
    # built scene (nothing moving, the lattice's pairs rest-filtered) it
    # drops blocks, so the compaction order is exercised too.
    _phase[0] = "k2_check"
    k2_report, k2_err = [], 0
    frames = (("check", pushed), ("built", b.state))
    for (frame, state), tile_j, rf in itertools.product(frames, (128, 256),
                                                        (True, False)):
        a = kernel_inputs(state, spec, tile_j, granular_groups=not rf)
        args = (a["rows"], a["cols"], a["keep"], a["prm"].collide_filter_dist,
                a["idx"], a["cnt"])
        ki, kc = ck.refine_overlap_blocks_packed(
            a["n"], *args, rest_filter=rf, tile_j=tile_j)
        pi, pc = ck.refine_blocks_plain(*args, rest_filter=rf, tile_j=tile_j)
        same = bool(torch.equal(ki, pi) and torch.equal(kc, pc))
        err = max(int((ki - pi).abs().max()), int((kc - pc).abs().max()))
        k2_err = max(k2_err, err)
        k2_report.append({"frame": frame, "keep_dist": float(a["keep"]),
                          "tile_j": tile_j, "rest_filter": rf,
                          "equal": same, "max_abs_err": err,
                          "listed": int(a["cnt"].sum()),
                          "kept": int(kc.sum()), "overflow": a["overflow"]})
        if not same:
            raise RuntimeError(f"K2 disagrees with its plain version: "
                               f"{k2_report[-1]}")
    emit({"phase": "k2_check", "ok": True, "cases": k2_report})

    # K1 against its plain version, over the refined lists
    _phase[0] = "k1_check"
    k1_report, k1_err = [], 0.0
    for tile_j in (128, 256):
        for rf in (True, False):
            a = kernel_inputs(pushed, spec, tile_j, granular_groups=not rf)
            prm = a["prm"]
            ridx, rcnt = ck.refine_blocks_plain(
                a["rows"], a["cols"], a["keep"], prm.collide_filter_dist,
                a["idx"], a["cnt"], rest_filter=rf, tile_j=tile_j)
            args = (a["rows1"], a["cols1"], prm.solid_rest_distance,
                    prm.particle_friction, prm.collide_filter_dist, ridx, rcnt)
            kd, kc = ck.block_sparse_contact_deltas_packed(
                a["n"], *args, rest_filter=rf, tile_j=tile_j)
            pd, pc = ck.block_sparse_contact_plain(a["n"], *args,
                                                   rest_filter=rf,
                                                   tile_j=tile_j)
            err = float((kd - pd).abs().max())
            contacts = int(pc.sum())
            k1_err = max(k1_err, err)
            counts_equal = bool(torch.equal(kc, pc))
            again = repeats(lambda: ck.block_sparse_contact_deltas_packed(
                a["n"], *args, rest_filter=rf, tile_j=tile_j))
            k1_report.append({"tile_j": tile_j, "rest_filter": rf,
                              "counts_equal": counts_equal,
                              "contacts": contacts, "max_abs_err": err,
                              "repeats_bitwise": again,
                              "finite": bool(torch.isfinite(kd).all())})
            if (not counts_equal or not err <= K1_ATOL or contacts == 0
                    or not again):
                raise RuntimeError(f"K1 check failed: {k1_report[-1]}")
    emit({"phase": "k1_check", "ok": True, "atol": K1_ATOL,
          "cases": k1_report})

    # the main path, through the entry point a user calls
    _phase[0] = "main_path"
    rollout_steps(b.state, spec, pos_traj[:2], quat_traj[:2], b.substeps,
                  b.iterations, record=False)  # warm-up (cuBLAS, allocator)
    reset_counts()
    (final, rec), secs = sync_time(lambda: rollout_steps(
        b.state, spec, pos_traj, quat_traj, b.substeps, b.iterations))
    launches = read_counts()
    per_frame_iters = b.substeps * b.iterations
    overflow = int(final.contact_overflow)
    finite = bool(torch.isfinite(rec).all())
    moved = float((rec[-1] - b.state.particles.pos).abs().max())
    emit({"phase": "main_path", "frames": T_MAIN, "seconds": secs,
          "frames_per_s": T_MAIN / secs, "ms_per_frame": 1e3 * secs / T_MAIN,
          "launches": launches, "contact_overflow": overflow,
          "finite": finite, "max_displacement": moved})
    if (launches["k1"] != per_frame_iters * T_MAIN
            or launches["k2"] != T_MAIN or launches["k3"] != 0
            or launches["k4"] != 0 or overflow != 0 or not finite):
        raise RuntimeError("main path check failed")

    _phase[0] = "bench_pinned"
    bp = rope_design_point(dev, lifted=False)
    ptj, qtj = pusher_sweep(bp, T_MAIN)
    (fp, _), secs_p = sync_time(lambda: rollout_steps(
        bp.state, bp.spec, ptj, qtj, bp.substeps, bp.iterations,
        record=False))
    movable_p = int(((bp.state.particles.inv_mass > 0)
                     & bp.state.particles.active).sum())
    emit({"phase": "bench_pinned", "ok": True, "frames": T_MAIN,
          "movable": movable_p, "frames_per_s": T_MAIN / secs_p,
          "ms_per_frame": 1e3 * secs_p / T_MAIN,
          "finite": bool(torch.isfinite(fp.particles.pos).all())})

    # kernel and plain-version times at the rope main path's shapes
    _phase[0] = "kernel_times"
    a = kernel_inputs(pushed, spec, 128)
    prm = a["prm"]
    ridx, rcnt = ck.refine_blocks_plain(a["rows"], a["cols"], a["keep"],
                                        prm.collide_filter_dist, a["idx"],
                                        a["cnt"], tile_j=128)
    n, n_pad = a["n"], a["cols"].shape[1]
    nb, maxb = ridx.shape
    stream = torch.cuda.current_stream().cuda_stream
    s1 = ck.device_scalars(dev, prm.solid_rest_distance,
                            prm.particle_friction, prm.collide_filter_dist)
    s2 = ck.device_scalars(dev, a["keep"], prm.collide_filter_dist)
    delta = torch.empty((n, 3), device=dev)
    count = torch.empty((n,), device=dev)
    new_idx, new_cnt = torch.empty_like(a["idx"]), torch.empty_like(a["cnt"])
    k1_ptrs = [t.data_ptr() for t in (a["rows1"], a["cols1"], ridx, rcnt, s1,
                                      delta, count)]
    k2_ptrs = [t.data_ptr() for t in (a["rows"], a["cols"], a["idx"],
                                      a["cnt"], s2, new_idx, new_cnt)]

    def k1_raw():
        build.check(lib, lib.ag_block_sparse_contact(
            *k1_ptrs, n, n_pad, maxb, 128, 1, stream), "K1")

    def k2_raw():
        build.check(lib, lib.ag_refine_blocks(
            *k2_ptrs, n_pad, maxb, 128, 1, stream), "K2")

    k1_args = (n, a["rows1"], a["cols1"], prm.solid_rest_distance,
               prm.particle_friction, prm.collide_filter_dist, ridx, rcnt)
    k2_args = (a["rows"], a["cols"], a["keep"], prm.collide_filter_dist,
               a["idx"], a["cnt"])
    times = {
        "k1_plain_a": event_ms(lambda: ck.block_sparse_contact_plain(*k1_args), 10),
        "k1": event_ms(k1_raw, 200),
        "k1_b": event_ms(k1_raw, 200),
        "k1_plain_b": event_ms(lambda: ck.block_sparse_contact_plain(*k1_args), 10),
        "k2_plain_a": event_ms(lambda: ck.refine_blocks_plain(*k2_args), 10),
        "k2": event_ms(k2_raw, 200),
        "k2_b": event_ms(k2_raw, 200),
        "k2_plain_b": event_ms(lambda: ck.refine_blocks_plain(*k2_args), 10),
    }
    _, pc = ck.block_sparse_contact_plain(*k1_args)
    pairs_k1 = int(rcnt.sum()) * 128 * 128
    pairs_k2 = int(a["cnt"].sum()) * 128 * 128
    near_k2 = near_pairs(a["rows"], a["cols"], a["keep"], a["idx"], a["cnt"],
                         128)
    contacts = int(pc.sum())
    table_bytes = 2 * n_pad * 16 * 4
    list_bytes = (nb * maxb + nb) * 4
    k1_bytes = table_bytes + list_bytes + 3 * 4 + n * 4 * 4
    k2_bytes = table_bytes + 2 * list_bytes + 2 * 4
    k1_ops = DETECT_OPS * pairs_k1 + PROJECT_OPS * contacts
    k2_ops = DETECT_OPS * near_k2

    b1, by1 = bound(k1_bytes, k1_ops)
    b2, by2 = bound(k2_bytes, k2_ops)
    rope_geometry = {"k1": build.launch_geometry(lib, "k1", n_pad, maxb),
                     "k2": build.launch_geometry(lib, "k2", n_pad, maxb)}
    # emitted with the granular kernels' times after the granular phases
    rope_times = {
        "times_ms": times,
        "k1": {"listed_blocks": int(rcnt.sum()), "pairs": pairs_k1,
               "contacts": contacts, "bytes": k1_bytes, "ops": k1_ops},
        "k2": {"listed_blocks": int(a["cnt"].sum()),
               "listed_pairs": pairs_k2, "near_pairs": near_k2,
               "bytes": k2_bytes, "ops": k2_ops}}

    # three frames on the card against three on the CPU from the same
    # state. From the built scene (free fall, no contact) the two differ by
    # rounding only, held to FRAME_ATOL. Then two windows with contacts:
    # across the contact onset (from the frame before the first one with
    # particle contacts) and from the check frame (the most contacts, the
    # rope on the floor). There a contact decision that rounding flips
    # changes a particle's Jacobi count, which divides all its other
    # corrections anew, so the frame is not continuous in its input and a
    # few particles part by far more than rounding; the CPU against itself
    # under a 1e-6 nudge of its input positions is reported beside it. Such
    # a window is held in bulk and in its tail: the median particle to
    # CONTACT_MEDIAN_ATOL (particles away from a flipped contact part by
    # rounding only) and every particle to CONTACT_MAX_FRAC of the contact
    # distance (a flip changes part of one contact correction; a wrong
    # frame moves particles by whole corrections).
    _phase[0] = "frame_agreement"
    spec_cpu = tree_to(spec, "cpu")

    def three(state, start, device):
        sl = slice(start, start + 3)
        fin, rec = rollout_steps(tree_to(state, device),
                                 spec if device != "cpu" else spec_cpu,
                                 pos_traj[sl], quat_traj[sl], b.substeps,
                                 b.iterations)
        return rec.cpu(), int(fin.contact_overflow)

    g0, og = three(b.state, 0, dev)
    c0, oc = three(b.state, 0, "cpu")
    diff0 = float((g0 - c0).abs().max())
    max_diff = float(CONTACT_MAX_FRAC * spec.params.solid_rest_distance)
    windows, failed = {}, []
    for name, state, start in (("contact_onset", before_onset, t_on),
                               ("check_frame", pushed, t_check + 1)):
        g, _ = three(state, start, dev)
        c, _ = three(state, start, "cpu")
        noise = np.random.RandomState(1).randn(*state.particles.pos.shape)
        nudged = state._replace(particles=state.particles._replace(
            pos=state.particles.pos + torch.as_tensor(
                noise * 1e-6, dtype=torch.float32, device=dev)))
        cn, _ = three(nudged, start, "cpu")
        per_particle = (g - c).abs().amax(dim=(0, 2))
        w = windows[name] = {
            "start": start,
            "first_iteration_contacts": by_frame[max(start - 1, 0):start + 2],
            "card_vs_cpu_max": float(per_particle.max()),
            "card_vs_cpu_median": float(per_particle.median()),
            "cpu_vs_cpu_nudged_1e-6_max": float((cn - c).abs().max()),
            "max_displacement": float(
                (c[-1] - state.particles.pos.cpu()).abs().max())}
        if not (w["card_vs_cpu_median"] <= CONTACT_MEDIAN_ATOL
                and w["card_vs_cpu_max"] <= max_diff):
            failed.append(name)
    emit({"phase": "frame_agreement", "frames": 3, "atol": FRAME_ATOL,
          "from_built_scene": {"max_abs_diff": diff0,
                               "max_displacement": float(
                                   (c0[-1] - b.state.particles.pos.cpu())
                                   .abs().max()),
                               "overflow": [og, oc]},
          "contact_median_atol": CONTACT_MEDIAN_ATOL,
          "contact_max_atol": max_diff, **windows})
    if not diff0 <= FRAME_ATOL:
        raise RuntimeError("card and CPU frames from the built scene "
                           "disagree")
    if failed:
        raise RuntimeError(f"card and CPU frames disagree in {failed}")

    gran = granular_phases(dev, lib)
    gt = gran["times"]

    # K2's edges: the granular design point's first frame after landing
    # (lists up to 20 blocks long, none kept), bench.py's pinned rope
    # (every block pruned),
    # and synthetic lists on the rope's check frame (tiles listing none,
    # tiles listing maxb, stale indices past each count) in K2's four forms
    _phase[0] = "k2_edges"
    cases = [("granular_landed", gran["k2_landed_args"], DESIGN["tile_j"],
              False)]
    a = kernel_inputs(bp.state, bp.spec, 128)
    cases.append(("bench_pinned", (a["rows"], a["cols"], a["keep"],
                                   a["prm"].collide_filter_dist, a["idx"],
                                   a["cnt"]), 128, True))
    for tile_j, rf in itertools.product((128, 256), (True, False)):
        a = kernel_inputs(pushed, spec, tile_j, granular_groups=not rf)
        nb, maxb = a["idx"].shape
        idx, cnt = edge_block_lists(nb, a["cols"].shape[1] // tile_j, maxb,
                                    seed=tile_j + rf)
        cases.append(("synthetic", (
            a["rows"], a["cols"], a["keep"], a["prm"].collide_filter_dist,
            torch.as_tensor(idx, device=dev),
            torch.as_tensor(cnt, device=dev)), tile_j, rf))
    edges = k2_edges(cases)
    ok = all(c["equal"] and c["repeats_bitwise"] for c in edges)
    emit({"phase": "k2_edges", "ok": ok, "cases": edges})
    if not ok:
        raise RuntimeError("K2 disagrees with its plain version on an edge "
                           "case")
    emit({"phase": "kernel_times", "ok": True, "rope": rope_times,
          "granular": {"times_ms": gt, **gran["detail"]},
          "library_ms": "null: no single PyTorch call computes any of the "
                        "four functions"})

    # launches: each path's counts, read just after it ran from zero
    by_path = {"rope_main_path": launches,
               "granular_path": gran["granular_counts"],
               "granular_dense_path": gran["dense_counts"]}

    def total(key):
        return sum(c[key] for c in by_path.values())

    def per_path(key):
        return {p: c[key] for p, c in by_path.items()}

    src = "adaptigraph_torch/kernels/csrc/contact.cu"
    pk = "adaptigraph_tpu/engine/pallas_kernels.py"
    b3, by3 = gran["k3_bound"]
    b4, by4 = gran["k4_bound"]
    k4_alone = min(gt["k4_alone"], gt["k4_alone_b"])
    k1_empty = min(gt["k1_empty"], gt["k1_empty_b"])

    def at_design_point(key):
        ms, by = gran[f"{key}_bound"]
        return {"ms": min(gt[f"{key}_granular"], gt[f"{key}_granular_b"]),
                "plain_ms": min(gt[f"{key}_granular_plain_a"],
                                gt[f"{key}_granular_plain_b"]),
                "bound_ms": ms, "bound_by": by,
                "geometry": gran["geometry"][f"{key}_granular"],
                "timed_at": f"granular design point's last frame, tile_j "
                            f"{gran['detail']['k1_granular']['tile_j']}, "
                            f"rest_filter off"}
    emit({"kernels": [
        {"name": "block_sparse_contact", "route": "cuda", "source": src,
         "replaces": f"{pk}:631",
         "launches": total("k1"), "launches_by_path": per_path("k1"),
         "max_abs_err": max(k1_err, gran["k1_err"], gran["k1_full_err"]),
         "ms": min(times["k1"], times["k1_b"]),
         "plain_ms": min(times["k1_plain_a"], times["k1_plain_b"]),
         "bound_ms": b1, "bound_by": by1, "library_ms": None,
         "geometry": rope_geometry["k1"],
         "timed_at": "rope check frame, tile_j 128, rest_filter on",
         "granular": at_design_point("k1"),
         "fused_granular_ms": min(gt["k1_fused_granular"],
                                  gt["k1_fused_granular_b"])},
        {"name": "refine_blocks", "route": "cuda", "source": src,
         "replaces": f"{pk}:487",
         "launches": total("k2"), "launches_by_path": per_path("k2"),
         "max_abs_err": float(k2_err),
         "ms": min(times["k2"], times["k2_b"]),
         "plain_ms": min(times["k2_plain_a"], times["k2_plain_b"]),
         "bound_ms": b2, "bound_by": by2, "library_ms": None,
         "geometry": rope_geometry["k2"],
         "timed_at": "rope check frame, tile_j 128, rest_filter on",
         "granular": at_design_point("k2"),
         "granular_landed": {
             "ms": min(gt["k2_landed"], gt["k2_landed_b"]),
             "plain_ms": min(gt["k2_landed_plain_a"],
                             gt["k2_landed_plain_b"]),
             "bound_ms": gran["k2_landed_bound"][0],
             "bound_by": gran["k2_landed_bound"][1],
             "timed_at": f"granular design point's frame {T_LANDED}, its "
                         f"first frame after landing"}},
        {"name": "dense_contact", "route": "cuda", "source": src,
         "replaces": f"{pk}:712",
         "launches": total("k3"), "launches_by_path": per_path("k3"),
         "max_abs_err": gran["k3_err"],
         "ms": min(gt["k3"], gt["k3_b"]),
         "plain_ms": min(gt["k3_plain_a"], gt["k3_plain_b"]),
         "bound_ms": b3, "bound_by": by3, "library_ms": None,
         "geometry": gran["geometry"]["k3"],
         "timed_at": "dense band frame with the most contacts"},
        {"name": "shape_stage_fused", "route": "cuda", "source": src,
         "replaces": f"{pk}:137",
         "launches": total("k4"), "launches_by_path": per_path("k4"),
         "max_abs_err": gran["k4_err"],
         "ms": k4_alone - k1_empty,
         "plain_ms": min(gt["k4_plain_a"], gt["k4_plain_b"]),
         "bound_ms": b4, "bound_by": by4, "library_ms": None,
         "alone_ms": k4_alone, "k1_empty_ms": k1_empty,
         "fused_increment_ms": (
             min(gt["k1_fused_granular"], gt["k1_fused_granular_b"])
             - min(gt["k1_granular"], gt["k1_granular_b"])),
         "unfused_pass_ms": min(gt["unfused_shape_pass_a"],
                                gt["unfused_shape_pass_b"]),
         "geometry": gran["geometry"]["k1_granular"],
         "timed_at": "granular design point's last frame: the fused launch "
                     "over empty block lists less the unfused one (alone_ms "
                     "less k1_empty_ms); fused_increment_ms over the "
                     "frame's lists"},
    ]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # report the phase, then fail without a result
        traceback.print_exc()
        print(json.dumps({"phase": _phase[0], "ok": False,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        sys.exit(1)
