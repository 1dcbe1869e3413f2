"""Where the time of a simulator frame goes, on one GPU.

    python -m adaptigraph_torch.tools.profile_frame [--scene rope]
        [--frames 5] [--start 90] [--trace PATH]

Drives rollout_steps on a design point of scenes.design_point (`rope`: the
rope lifted so it moves, the pusher's 200-frame sweep; `granular`: the 27k
granular point with the shapes fused into the sweep, the board's sweep;
`granular_dense`: the dense band, the same sweep; `cloth`: the 4,900-
particle sheet, the box's sweep, from frame 16 by default, the box then
pushing the landed sheet) and profiles a few frames with torch.profiler
after running the frames before them.
Prints one JSON line: wall ms per frame, device busy ms per frame
(the sum of kernel times; one stream, so kernels do not overlap), the
device idle share, kernel launches per frame, and the kernels with the most
device time, and the launches and device time of one call of each
iteration pass outside the contact kernels (the unfused shape pass, the
offset-family spring pass) at the first profiled frame's positions. Optionally writes a Chrome trace. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from adaptigraph_torch.engine.solver import rollout_steps
from adaptigraph_torch.scenes import design_point as dp


def _scene(name: str, dev, frames: int):
    """(build, shape trajectory, rollout keywords) of a design point."""
    if name == "rope":
        b = dp.rope_design_point(dev)
        return b, dp.pusher_sweep(b, max(200, frames)), {}
    if name == "granular":
        b = dp.granular_scene(device=dev)
        return b, dp.board_sweep(b, frames), dict(
            rest_filter=False,
            n_shapes_active=int(b.state.shapes.kind.shape[0]))
    if name == "cloth":
        b = dp.cloth_design_point(dev)
        return b, dp.cloth_sweep(b, frames), {}
    b = dp.granular_dense_point(dev)
    return b, dp.board_sweep(b, frames), {}


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profiled(fn, frames: int) -> dict:
    """Run fn (which runs `frames` frames) under torch.profiler: wall ms
    and device busy ms a frame (the sum of kernel times; one stream, so
    kernels do not overlap), the idle share, kernel launches a frame, the
    kernels by device time, and the profile itself."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kernels.append((us, evt.count, evt.key))
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    return {"wall_ms_per_frame": 1e3 * wall / frames,
            "device_busy_ms_per_frame": busy_us / 1e3 / frames,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "kernel_launches_per_frame": sum(k[1] for k in kernels) / frames,
            "top_kernels": [{"name": k[2][:90],
                             "ms_per_frame": k[0] / 1e3 / frames,
                             "launches_per_frame": k[1] / frames}
                            for k in kernels[:12]],
            "profile": prof}


def pass_profiles(b, st) -> dict:
    """Kernel launches and device ms of one call of each iteration pass
    outside the contact kernels, on the state's positions."""
    from adaptigraph_torch.engine.collisions import shape_contact_deltas
    from adaptigraph_torch.engine.solver import _spring_deltas_offset

    spec, prm, p, sh = b.spec, b.spec.params, st.particles, st.shapes
    s_vel = (sh.pos - sh.prev_pos) / prm.dt
    passes = {"shape_pass": lambda: shape_contact_deltas(
        p.pos, p.pos, sh, sh.pos, sh.quat, s_vel, prm.collision_distance,
        prm.shape_collision_margin, prm.dynamic_friction,
        prm.dt / b.substeps)}
    if spec.offset_springs is not None:
        passes["offset_springs"] = lambda: _spring_deltas_offset(
            p.pos, p.inv_mass, spec.offset_springs)
    out = {}
    for name, fn in passes.items():
        fn()  # warm-up
        r = profiled(fn, 1)
        out[name] = {"launches_per_call": r["kernel_launches_per_frame"],
                     "device_ms_per_call": r["device_busy_ms_per_frame"],
                     "wall_ms_per_call": r["wall_ms_per_frame"]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="rope",
                    choices=("rope", "granular", "granular_dense", "cloth"))
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--start", type=int, default=None,
                    help="first profiled frame of the sweep (default 90; "
                         "cloth 16)")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    dev = torch.device("cuda")
    if args.start is None:
        args.start = 16 if args.scene == "cloth" else 90
    b, (pos_traj, quat_traj), kw = _scene(args.scene, dev,
                                          args.start + args.frames)
    st, _ = rollout_steps(b.state, b.spec, pos_traj[:args.start],
                          quat_traj[:args.start], b.substeps, b.iterations,
                          record=False, **kw)
    sl = slice(args.start, args.start + args.frames)
    res = profiled(lambda: rollout_steps(
        st, b.spec, pos_traj[sl], quat_traj[sl], b.substeps, b.iterations,
        record=False, **kw), args.frames)
    prof = res.pop("profile")
    res["passes"] = pass_profiles(b, st)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "scene": args.scene,
        "frames": args.frames, "first_frame": args.start, **res}),
        flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
