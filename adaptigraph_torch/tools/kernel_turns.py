"""Time this tree's contact kernels against another version of them, in
turns, on one GPU.

    git show REV:adaptigraph_torch/kernels/csrc/contact.cu > base.cu
    python -m adaptigraph_torch.tools.kernel_turns --base base.cu
        [--splits 1,2,4,8] [--frames 4] [--out turns.json]

Builds `--base` and this tree's `kernels/csrc/contact.cu` into two
libraries, and with --splits this tree's source once more for each
cluster size S (-DAG_SPLIT=S: the sweep's and K2's): one nvcc each, all
started together, with kernels/build.py's flags, under
kernels/_build/turns/. On the inputs below it launches each kernel
through every library, checks that its counts (K2: its lists) equal this
tree's, and times raw launches with CUDA events, the libraries in turns:
base, this, this, base, base, this, then each S.

- rope: the rope design point at frame 18 of the pusher's 80-frame sweep
  (the smoke's check frame): K1 at tile_j 128 with the rest filter over
  K2's lists, and K2;
- granular: the granular design point at frame 36 of the board's sweep:
  K1 at tile_j 256 without the rest filter, unfused and with the shapes
  fused, K4 alone (the fused launch over empty lists) beside K1 over the
  same empty lists (`k1_empty`, the launch K4 alone stands on), and K2;
- granular_landed: the same point at frame 8, its first frame after
  landing (lists up to 20 blocks a row tile, no granule yet within the
  keep distance of another): K2;
- dense: the dense band's built frame with each granule moved 0.07 x its
  index back along z (the smoke's `pressed` frame): K3, and K1 over full
  lists.

With --frames F it then runs each design point on from those frames
through rollout_steps with each library in turns (base, this, this,
base): frames/s over F frames, then device ms and launches a frame from
torch.profiler over 2 more. Prints one JSON line a case and the card's
name and power limit; --out keeps them all in one JSON file, rewritten
after every case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

from adaptigraph_torch.engine import contact_kernels as ck
from adaptigraph_torch.engine.solver import (
    _shape_table, auto_tile_j, frame_block_lists, pack_tables_for,
    rollout_steps)
from adaptigraph_torch.kernels import build
from adaptigraph_torch.scenes import design_point as dp
from adaptigraph_torch.tools.profile_frame import profiled

TURNS = ("base", "this", "this", "base", "base", "this")
ROPE_FRAME, ROPE_SWEEP = 18, 80
GRANULAR_LANDED, GRANULAR_FRAME, DENSE_FRAMES = 8, 36, 10


def _libraries(base: str, splits, out_dir) -> dict:
    """name -> loaded library: `base`, `this` and `S<s>` for each split."""
    jobs = {"base": (base, ()), "this": (str(build.SOURCE), ())}
    for s in splits:
        jobs[f"S{s}"] = (str(build.SOURCE), (f"-DAG_SPLIT={s}",))
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name, (src, extra) in jobs.items():
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, *extra, "-o", str(so), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in build.SIGNATURES.items():
            if hasattr(lib, fn):  # an older library may lack an entry
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
        lib.ag_error_string.argtypes = [ctypes.c_int]
        lib.ag_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _ptrs(*ts):
    return [None if t is None else t.data_ptr() for t in ts]


def _sweep_inputs(state, spec, tile_j, rest_filter, dev):
    """K1's and K2's inputs at a frame's start, as xpbd_step builds them,
    with K1's lists refined by K2's plain version."""
    p, prm, sh = state.particles, spec.params, state.shapes
    rows, cols = pack_tables_for(p, spec, tile_j)
    s_vel = (sh.pos - sh.prev_pos) / prm.dt
    idx, cnt, _, keep = frame_block_lists(p, spec, s_vel, tile_j)
    ridx, rcnt = ck.refine_blocks_plain(rows, cols, keep,
                                        prm.collide_filter_dist, idx, cnt,
                                        rest_filter=rest_filter,
                                        tile_j=tile_j)
    return dict(
        n=p.pos.shape[0], rows=rows, cols=cols, idx=idx, cnt=cnt, ridx=ridx,
        rcnt=rcnt, tile_j=tile_j, rf=int(rest_filter), s_vel=s_vel,
        s1=ck.device_scalars(dev, prm.solid_rest_distance,
                             prm.particle_friction, prm.collide_filter_dist),
        s2=ck.device_scalars(dev, keep, prm.collide_filter_dist))


def _cases(a, stream, fused=None):
    """(name, kernel, make) for K1 and K2 at inputs `a` (and K1 with K4, K4
    alone and K1 over the same empty lists when `fused` holds the shape
    inputs). make(lib) returns (launch, outputs)."""
    n, n_pad = a["n"], a["cols"].shape[1]
    maxb = a["ridx"].shape[1]

    def k1(cnt, shapes):
        def make(lib):
            d = torch.empty((n, 3), device=a["rows"].device)
            c = torch.empty((n,), device=a["rows"].device)
            head = _ptrs(a["rows"], a["cols"], a["ridx"], cnt)
            if shapes is None:
                args = (*head, *_ptrs(a["s1"], d, c), n, n_pad, maxb,
                        a["tile_j"], a["rf"], stream)
                return (lambda: build.check(
                    lib, lib.ag_block_sparse_contact(*args), "K1")), (d, c)
            f = shapes
            args = (*head, *_ptrs(f["s4"], f["shp"], f["planes"], d, c), n,
                    n_pad, maxb, a["tile_j"], a["rf"], f["n_shapes"],
                    f["n_planes"], stream)
            return (lambda: build.check(
                lib, lib.ag_block_sparse_contact_shapes(*args), "K4")), (d, c)
        return make

    def k2(lib):
        ni, nc = torch.empty_like(a["idx"]), torch.empty_like(a["cnt"])
        args = (*_ptrs(a["rows"], a["cols"], a["idx"], a["cnt"], a["s2"], ni,
                       nc), n_pad, a["idx"].shape[1], a["tile_j"], a["rf"],
                stream)
        return (lambda: build.check(lib, lib.ag_refine_blocks(*args),
                                    "K2")), (ni, nc)

    out = [("k1", "k1", k1(a["rcnt"], None))]
    if fused is not None:
        empty = torch.zeros_like(a["rcnt"])
        out += [("k1_fused", "k1", k1(a["rcnt"], fused)),
                ("k4_alone", "k1", k1(empty, fused)),
                ("k1_empty", "k1", k1(empty, None))]
    return out + [("k2", "k2", k2)]


def _dense_cases(n, rows, cols, scal, stream):
    """K3 and K1 over full lists on the dense band's tables."""
    n_pad = cols.shape[1]
    nb = n_pad // ck.TILE
    full_idx = torch.arange(nb, dtype=torch.int32,
                            device=rows.device).repeat(nb, 1)
    full_cnt = torch.full((nb,), nb, dtype=torch.int32, device=rows.device)

    def outputs():
        return (torch.empty((n, 3), device=rows.device),
                torch.empty((n,), device=rows.device))

    def k3(lib):
        d, c = outputs()
        args = (*_ptrs(rows, cols, scal, d, c), n, n_pad, stream)
        return (lambda: build.check(lib, lib.ag_dense_contact(*args),
                                    "K3")), (d, c)

    def k1_full(lib):
        d, c = outputs()
        args = (*_ptrs(rows, cols, full_idx, full_cnt, scal, d, c), n, n_pad,
                nb, ck.TILE, 1, stream)
        return (lambda: build.check(lib, lib.ag_block_sparse_contact(*args),
                                    "K1")), (d, c)

    return [("k3", "k3", k3), ("k1_full_list", "k1", k1_full)], nb


def event_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean device time of one call of fn over reps back-to-back calls."""
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


def _time_case(point, name, kernel, make, libs, order, n_pad, maxb):
    made = {k: make(lib) for k, lib in libs.items()}
    for launch, _ in made.values():
        launch()
    torch.cuda.synchronize()
    ref = made["this"][1]
    r = {"point": point, "case": name,
         "geometry": build.launch_geometry(libs["this"], kernel, n_pad,
                                           maxb)}
    for k, (_, outs) in made.items():
        if kernel == "k2":
            r[f"{k}_equal"] = all(torch.equal(x, y)
                                  for x, y in zip(outs, ref))
        else:
            r[f"{k}_counts_equal"] = bool(torch.equal(outs[1], ref[1]))
            r[f"{k}_max_abs_diff"] = float((outs[0] - ref[0]).abs().max())
    times = {k: [] for k in libs}
    for k in order:
        times[k].append(event_ms(made[k][0], 100))
    r["ms"] = times
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="another version of kernels/csrc/contact.cu")
    ap.add_argument("--splits", default="",
                    help="cluster sizes to time this tree's sweep at, e.g. "
                         "1,2,4,8")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    splits = [int(s) for s in args.splits.split(",") if s]
    if any(s not in (1, 2, 4, 8) for s in splits):
        raise SystemExit("--splits takes 1, 2, 4 or 8")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=15).stdout.strip()
    t0 = time.perf_counter()
    libs = _libraries(args.base, splits, build.BUILD_DIR / "turns")
    order = TURNS + tuple(f"S{s}" for s in splits)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    build._lib = libs["this"]  # the wrappers launch through build._lib
    results = [{"card": smi, "built_s": time.perf_counter() - t0}]

    def emit(r):
        results.append(r)
        print(json.dumps(r), flush=True)
        if args.out:  # rewritten after every case, so a cut run keeps them
            with open(args.out, "w") as fh:
                json.dump(results, fh, indent=1)

    # the three points, and the state each runs on from with --frames
    rope = dp.rope_design_point(dev)
    rtraj = dp.pusher_sweep(rope, ROPE_SWEEP)
    rst, _ = rollout_steps(rope.state, rope.spec, rtraj[0][:ROPE_FRAME],
                           rtraj[1][:ROPE_FRAME], rope.substeps,
                           rope.iterations, record=False)
    gran = dp.granular_scene(device=dev)
    gkw = dict(rest_filter=bool(
        gran.state.particles.self_collide[: gran.n_active].any()),
        n_shapes_active=int(gran.state.shapes.kind.shape[0]))
    gtraj = dp.board_sweep(gran, GRANULAR_FRAME + args.frames + 2)
    landed, _ = rollout_steps(gran.state, gran.spec,
                              gtraj[0][:GRANULAR_LANDED],
                              gtraj[1][:GRANULAR_LANDED], gran.substeps,
                              gran.iterations, record=False, **gkw)
    sl = slice(GRANULAR_LANDED, GRANULAR_FRAME)
    gst, _ = rollout_steps(landed, gran.spec, gtraj[0][sl], gtraj[1][sl],
                           gran.substeps, gran.iterations, record=False,
                           **gkw)
    dense = dp.granular_dense_point(dev)
    dtraj = dp.board_sweep(dense, DENSE_FRAMES + args.frames + 2)
    dst, _ = rollout_steps(dense.state, dense.spec, dtraj[0][:DENSE_FRAMES],
                           dtraj[1][:DENSE_FRAMES], dense.substeps,
                           dense.iterations, record=False)

    a = _sweep_inputs(rst, rope.spec, 128, True, dev)
    cases = [("rope", a, c) for c in _cases(a, stream)]
    g = _sweep_inputs(gst, gran.spec, auto_tile_j(gst.particles.pos.shape[0]),
                      gkw["rest_filter"], dev)
    prm, sh, m = gran.spec.params, gst.shapes, gkw["n_shapes_active"]
    shp, planes2d = _shape_table(sh, sh.pos, sh.quat, g["s_vel"], m)
    fused = dict(
        shp=shp, planes=planes2d, n_shapes=m,
        n_planes=0 if planes2d is None else planes2d.shape[0] // m,
        s4=ck.device_scalars(dev, prm.solid_rest_distance,
                             prm.particle_friction, prm.collide_filter_dist,
                             prm.collision_distance,
                             prm.shape_collision_margin,
                             prm.dynamic_friction, prm.dt / gran.substeps))
    cases += [("granular", g, c) for c in _cases(g, stream, fused)]
    gl = _sweep_inputs(landed, gran.spec, g["tile_j"], gkw["rest_filter"],
                       dev)
    cases += [("granular_landed", gl, c) for c in _cases(gl, stream)
              if c[0] == "k2"]
    for point, a, (name, kernel, make) in cases:
        idx, cnt = (a["idx"], a["cnt"]) if kernel == "k2" else (a["ridx"],
                                                                a["rcnt"])
        emit({**_time_case(point, name, kernel, make, libs, order,
                           a["cols"].shape[1], idx.shape[1]),
              "listed_blocks": int(cnt.sum()),
              "max_blocks_per_tile": int(cnt.max())})

    p = dense.state.particles
    pressed = p.pos.clone()
    pressed[:, 2] -= 0.07 * p.group.clamp(min=0).float()
    rows, cols = ck.pack_contact_tables(pressed, p.pos, p.group, p.inv_mass,
                                        p.self_collide, p.active,
                                        dense.spec.rest_pos)
    dprm = dense.spec.params
    scal = ck.device_scalars(dev, dprm.solid_rest_distance,
                             dprm.particle_friction, dprm.collide_filter_dist)
    dcases, nb = _dense_cases(p.pos.shape[0], rows, cols, scal, stream)
    for name, kernel, make in dcases:
        emit(_time_case("dense", name, kernel, make, libs, order,
                        cols.shape[1], nb))

    if args.frames > 0:
        f = args.frames
        runs = (("rope", rope, rst, rtraj, ROPE_FRAME, {}),
                ("granular", gran, gst, gtraj, GRANULAR_FRAME, gkw),
                ("dense", dense, dst, dtraj, DENSE_FRAMES, {}))
        for point, b, st, (pt, qt), start, kw in runs:
            r = {"point": point, "frames": f, "first_frame": start}
            for k in ("base", "this", "this", "base"):
                build._lib = libs[k]
                sl = slice(start, start + f)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st2, _ = rollout_steps(st, b.spec, pt[sl], qt[sl],
                                       b.substeps, b.iterations,
                                       record=False, **kw)
                torch.cuda.synchronize()
                fps = f / (time.perf_counter() - t1)
                sl2 = slice(start + f, start + f + 2)
                prof = profiled(lambda: rollout_steps(
                    st2, b.spec, pt[sl2], qt[sl2], b.substeps, b.iterations,
                    record=False, **kw), 2)
                r.setdefault(k, []).append({
                    "frames_per_s": fps,
                    **{key: prof[key] for key in (
                        "device_busy_ms_per_frame", "device_idle_share",
                        "kernel_launches_per_frame")}})
            build._lib = libs["this"]
            emit(r)

    print(smi, flush=True)


if __name__ == "__main__":
    main()
