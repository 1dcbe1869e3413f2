"""Where the time of a simulator frame goes, on one GPU.

    python -m adaptigraph_torch.tools.profile_frame [--scene rope]
        [--frames 5] [--start 90] [--trace PATH]

Drives rollout_steps on a design point of scenes.design_point (`rope`: the
rope lifted so it moves, the pusher's 200-frame sweep; `granular`: the 27k
granular point with the shapes fused into the sweep, the board's sweep;
`granular_dense`: the dense band, the same sweep) and profiles
a few frames with torch.profiler after running the frames before them.
Prints one JSON line: wall ms per frame, device busy ms per frame
(the sum of kernel times; one stream, so kernels do not overlap), the
device idle share, kernel launches per frame, and the kernels with the most
device time. Optionally writes a Chrome trace. Needs a CUDA device.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="rope",
                    choices=("rope", "granular", "granular_dense"))
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--start", type=int, default=90,
                    help="first profiled frame of the sweep")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    dev = torch.device("cuda")
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
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "scene": args.scene,
        "frames": args.frames, "first_frame": args.start, **res}),
        flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
