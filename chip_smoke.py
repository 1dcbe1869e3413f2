"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from adaptigraph_torch/kernels/csrc with
nvcc, drives the simulator frame (rollout_steps on the rope scene at the
5,120-particle design point, 2 substeps x 4 iterations, a box pusher
sweeping through the rope) and holds each kernel against its plain PyTorch
version. Each phase prints one JSON line. The last lines are the kernel
table, the card's name and power limit, and the result line
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
T_MAIN = 200  # frames of the main-path rollout
T_PUSH = 100  # frames searched for the kernel checks' frame (pusher meets rope)
K1_ATOL = 2e-5  # tests/test_pallas_kernels.py's tolerance for the sweep
FRAME_ATOL = 1e-4  # card vs CPU positions, 3 frames from the built scene
# card vs CPU over 3 frames with contacts (see the frame_agreement phase):
# the median particle to 1e-5, every particle to a tenth of the contact
# distance
CONTACT_MEDIAN_ATOL, CONTACT_MAX_FRAC = 1e-5, 0.1
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_S = 67e12  # H100 SXM float32 outside the tensor cores
# float32 operations a pair costs: detection (differences, squares, sums,
# the compares) on every listed pair, projection on every contact pair
DETECT_OPS, PROJECT_OPS = 26, 52

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


def first_hit_pairs(rows, cols, keep_dist, filter_dist, block_idx,
                    block_cnt, tile_j):
    """Pairs K2's detection must evaluate on these inputs: each row thread
    scans a listed block's columns in order and stops at its first
    eligible one, so a (row, block) costs the columns up to and including
    that one, or the whole block when it holds none. Taken from the plain
    version's detection on the same inputs."""
    from adaptigraph_torch.engine import contact_kernels as ck

    nb = cols.shape[1] // ck.TILE
    r = rows.view(nb, ck.TILE, 16)
    keep_dist, filter_dist = (ck._f32(v, rows.device)
                              for v in (keep_dist, filter_dist))
    total = 0
    for k in range(int(block_cnt.max())):
        hit = ck._detect(r, ck._gather_blocks(cols, block_idx, k, tile_j),
                         keep_dist, filter_dist, True)[-1]
        scanned = torch.where(hit.any(-1), hit.int().argmax(-1) + 1, tile_j)
        total += int(scanned[block_cnt > k].sum())
    return total


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
            k1_report.append({"tile_j": tile_j, "rest_filter": rf,
                              "counts_equal": counts_equal,
                              "contacts": contacts, "max_abs_err": err,
                              "finite": bool(torch.isfinite(kd).all())})
            if not counts_equal or not err <= K1_ATOL or contacts == 0:
                raise RuntimeError(f"K1 check failed: {k1_report[-1]}")
    emit({"phase": "k1_check", "ok": True, "atol": K1_ATOL,
          "cases": k1_report})

    # the main path, through the entry point a user calls
    _phase[0] = "main_path"
    rollout_steps(b.state, spec, pos_traj[:2], quat_traj[:2], b.substeps,
                  b.iterations, record=False)  # warm-up (cuBLAS, allocator)
    k1_fn, k2_fn = ck.block_sparse_contact_deltas_packed, ck.refine_overlap_blocks_packed
    k1_fn.launches = 0
    k2_fn.launches = 0
    (final, rec), secs = sync_time(lambda: rollout_steps(
        b.state, spec, pos_traj, quat_traj, b.substeps, b.iterations))
    launches = {"k1": k1_fn.launches, "k2": k2_fn.launches}
    per_frame_iters = b.substeps * b.iterations
    overflow = int(final.contact_overflow)
    finite = bool(torch.isfinite(rec).all())
    moved = float((rec[-1] - b.state.particles.pos).abs().max())
    emit({"phase": "main_path", "frames": T_MAIN, "seconds": secs,
          "frames_per_s": T_MAIN / secs, "ms_per_frame": 1e3 * secs / T_MAIN,
          "launches": launches, "contact_overflow": overflow,
          "finite": finite, "max_displacement": moved})
    if (launches["k1"] != per_frame_iters * T_MAIN
            or launches["k2"] != T_MAIN or overflow != 0 or not finite):
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

    # kernel and plain-version times at the main path's shapes
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
    # K2 stops each row's scan of a block at its first eligible column
    pairs_k2 = first_hit_pairs(a["rows"], a["cols"], a["keep"],
                               prm.collide_filter_dist, a["idx"], a["cnt"],
                               128)
    contacts = int(pc.sum())
    table_bytes = 2 * n_pad * 16 * 4
    list_bytes = (nb * maxb + nb) * 4
    k1_bytes = table_bytes + list_bytes + 3 * 4 + n * 4 * 4
    k2_bytes = table_bytes + 2 * list_bytes + 2 * 4
    k1_ops = DETECT_OPS * pairs_k1 + PROJECT_OPS * contacts
    k2_ops = DETECT_OPS * pairs_k2

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
        return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")

    b1, by1 = bound(k1_bytes, k1_ops)
    b2, by2 = bound(k2_bytes, k2_ops)
    emit({"phase": "kernel_times", "ok": True, "times_ms": times,
          "k1": {"listed_blocks": int(rcnt.sum()), "pairs": pairs_k1,
                 "contacts": contacts, "bytes": k1_bytes, "ops": k1_ops},
          "k2": {"listed_blocks": int(a["cnt"].sum()),
                 "listed_pairs": int(a["cnt"].sum()) * 128 * 128,
                 "scanned_pairs": pairs_k2,
                 "bytes": k2_bytes, "ops": k2_ops},
          "library_ms": "null: no single PyTorch call computes either "
                        "function"})

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

    src = "adaptigraph_torch/kernels/csrc/contact.cu"
    emit({"kernels": [
        {"name": "block_sparse_contact", "route": "cuda", "source": src,
         "replaces": "adaptigraph_tpu/engine/pallas_kernels.py:631",
         "launches": launches["k1"], "max_abs_err": k1_err,
         "ms": min(times["k1"], times["k1_b"]),
         "plain_ms": min(times["k1_plain_a"], times["k1_plain_b"]),
         "bound_ms": b1, "bound_by": by1, "library_ms": None},
        {"name": "refine_blocks", "route": "cuda", "source": src,
         "replaces": "adaptigraph_tpu/engine/pallas_kernels.py:487",
         "launches": launches["k2"], "max_abs_err": float(k2_err),
         "ms": min(times["k2"], times["k2_b"]),
         "plain_ms": min(times["k2_plain_a"], times["k2_plain_b"]),
         "bound_ms": b2, "bound_by": by2, "library_ms": None},
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
