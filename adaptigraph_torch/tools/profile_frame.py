"""Where the time of a simulator frame goes, on one GPU.

    python -m adaptigraph_torch.tools.profile_frame [--frames 5] [--trace PATH]

Drives rollout_steps on the rope design point (scenes.design_point, rope
lifted so it moves) and profiles a few frames with torch.profiler after a
warm-up. Prints one JSON line: wall ms per frame, device busy ms per frame
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
from adaptigraph_torch.scenes.design_point import pusher_sweep, rope_design_point


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--start", type=int, default=90,
                    help="first profiled frame of the 200-frame sweep")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame needs a CUDA device")
    dev = torch.device("cuda")
    b = rope_design_point(dev)
    pos_traj, quat_traj = pusher_sweep(b, 200)
    st, _ = rollout_steps(b.state, b.spec, pos_traj[:args.start],
                          quat_traj[:args.start], b.substeps, b.iterations,
                          record=False)
    sl = slice(args.start, args.start + args.frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout_steps(st, b.spec, pos_traj[sl], quat_traj[sl], b.substeps,
                      b.iterations, record=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            kernels.append((us, evt.count, evt.key))
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    f = args.frames
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "frames": f,
        "first_frame": args.start, "wall_ms_per_frame": 1e3 * wall / f,
        "device_busy_ms_per_frame": busy_us / 1e3 / f,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches_per_frame": sum(k[1] for k in kernels) / f,
        "top_kernels": [{"name": k[2][:90], "ms_per_frame": k[0] / 1e3 / f,
                         "launches_per_frame": k[1] / f}
                        for k in kernels[:12]]}), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
