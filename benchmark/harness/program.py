"""The program's own spans and counters (adaptigraph_torch.utils.profiling)
in a traced run, and their place on the profiled segment's timeline.

start() resets and turns on the port's tracer just before the window;
finish(profiled) turns it off after the window, exports it, and reads the
raw torch.profiler capture before Profiled.summary() drops it. The spans'
host times go onto the profiler's clock by the tracer's anchor, and each
host runtime call that puts work on the device (a kernel launch, a copy, a
set) and each device idle gap is put under the innermost program span the
host was inside when the call was issued or the gap began ("none" where no
span was open). The spans never reach the device's timeline: the tracer
records no profiler range.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from harness.trace import _events

NONE = "none"  # the attribution of what falls under no program span

# host runtime calls that put an operation on the device
_LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                    "cudaMemset", "cuMemset", "cudaGraphLaunch",
                    "cuGraphLaunch")


def start() -> None:
    from adaptigraph_torch.utils import profiling
    profiling.reset()
    profiling.enable()


def finish(profiled=None) -> dict:
    """The tracer's export, with `launches` and `idle_s` ({span name:
    count or seconds}) over the profiled segment, empty without one."""
    from adaptigraph_torch.utils import profiling
    profiling.disable()
    out = profiling.export()
    prof = getattr(profiled, "_prof", None)
    dev, cpu = _events(prof) if prof is not None else ([], [])
    out.update(attribute(out["spans"], dev, cpu))
    return out


def innermost(spans: list):
    """(starts_us, labels): the profiler-clock times in us at which the
    innermost open span changes, and its name from each on (NONE where
    none is open). Spans nest, as context managers on one thread do."""
    marks = []
    for s in spans:
        marks.append((s["start_unix_ns"], 1, s["id"]))
        marks.append((s["end_unix_ns"], 0, s["id"]))
    marks.sort()
    names = {s["id"]: s["name"] for s in spans}
    starts, labels, stack = [-np.inf], [NONE], []
    for t, opening, sid in marks:
        if opening:
            stack.append(sid)
        elif sid in stack:
            stack.remove(sid)
        starts.append(t / 1e3)
        labels.append(names[stack[-1]] if stack else NONE)
    return np.array(starts), labels


def attribute(spans: list, dev: list, cpu: list,
              host_prefix: str = "bench:") -> dict:
    """From a profile's (name, start_us, end_us) device and host events:
    {"launches": {span: runtime calls issued inside it}, "idle_s": {span:
    device idle begun inside it}}, each by the innermost span."""
    starts, labels = innermost(spans)

    def under(times):
        return [labels[i] for i in np.searchsorted(starts, times,
                                                   side="right") - 1]

    launches = defaultdict(int)
    calls = [c[1] for c in cpu if c[0].startswith(_LAUNCH_PREFIXES)]
    for label in under(np.array(calls, dtype=float)):
        launches[label] += 1

    idle = defaultdict(float)
    dev = sorted((e for e in dev if not e[0].startswith(host_prefix)),
                 key=lambda e: e[1])
    if len(dev) > 1:
        s = np.array([e[1] for e in dev])
        reach = np.maximum.accumulate(np.array([e[2] for e in dev]))
        gap = s[1:] - reach[:-1]
        at = reach[:-1][gap > 0]
        for label, g in zip(under(at), gap[gap > 0]):
            idle[label] += g / 1e6
    return {"launches": dict(launches), "idle_s": dict(idle)}


def median(xs):
    xs = [x for x in xs if x is not None]
    return float(np.median(xs)) if xs else None


def _children_ms(prog, parent_name, tag, names):
    """For each span `parent_name` tagged `tag`, the device ms of its
    direct children named in `names`, summed; None without device times."""
    spans = prog["spans"]
    parents = {s["id"]: 0.0 for s in spans
               if s["name"] == parent_name and s["tag"] == tag}
    for s in spans:
        if s["parent"] in parents and s["name"] in names:
            if s["device_ms"] is None:
                return None
            parents[s["parent"]] += s["device_ms"]
    return list(parents.values()) or None


def _ratio(counters, num, den):
    d = counters.get(den, 0)
    return counters[num] / d if d and num in counters else None


def metrics(prog, run) -> dict:
    """The per-layer numbers the program's spans and counters give, each
    None where the run cannot give it (no card for device times or the
    profile's launches and idle; the other kind of cell)."""
    names = {s["name"] for s in prog["spans"]}
    c = prog["counters"]
    out = {}
    if "rollout.forward" in names:
        chunk = run.chunk
        inc = _children_ms(prog, "rollout.forward", chunk,
                           ("model.incidence", "model.gather",
                            "model.aggregate"))
        mlp = _children_ms(prog, "rollout.forward", chunk,
                           ("model.relation_mlp",))
        out["incidence_ms.mppi"] = median(inc or [])
        out["relation_mlp_ms.mppi"] = median(mlp or [])
        out["useful_forward_share.mppi"] = _ratio(
            c, "rollout.sample_forwards_needed", "rollout.sample_forwards_run")
        out["valid_edge_share.mppi"] = _ratio(c, "rollout.valid_edges",
                                              "rollout.edge_slots")
    if "train.step" in names:
        out["fps_host_ms.train"] = median(
            [(s["end_ns"] - s["start_ns"]) / 1e6 for s in prog["spans"]
             if s["name"] == "prepare.fps"])
        steps = getattr(run, "steps_profiled", 0)
        launches = prog.get("launches", {})
        out["fps_launches_per_step.train"] = (
            launches.get("prepare.fps", 0) / steps
            if steps and any(launches.values()) else None)
        idle = prog.get("idle_s", {})
        total = sum(idle.values())
        out["prepare_idle_share.train"] = (
            sum(idle.get(n, 0.0) for n in ("train.prepare", "prepare.fps",
                                           "prepare.edges")) / total
            if total > 0 else None)
    return out


def agreement(prog, hook_ms, run) -> dict:
    """{pair: [program's, harness's]}: the medians of the program's spans
    (device ms) beside those of the harness's CUDA-event hooks over the
    same window (Spans.ms()), and the planning counter of needed forwards
    beside the check's own count; only the pairs the cell has."""
    by = defaultdict(list)
    for s in prog["spans"]:
        by[s["name"]].append(s)

    def dev(name, tag=None, any_tag=False):
        return median([s["device_ms"] for s in by[name]
                        if any_tag or s["tag"] == tag])

    def hook(name, tag=None, any_tag=False):
        return median([m for m, t in hook_ms.get(name, [])
                        if any_tag or t == tag])

    out = {}
    if by["rollout.forward"]:
        out["rollout.forward~forward"] = [dev("rollout.forward", run.chunk),
                                          hook("forward", run.chunk)]
        out["rollout.edges~edges"] = [dev("rollout.edges", run.chunk),
                                      hook("edges", run.chunk)]
        out["plan.score~cost"] = [dev("plan.score", run.n_sample),
                                  hook("cost", run.n_sample)]
        # the forwards the pushes need, as the check counts them from the
        # actions (every call of the window)
        out["rollout.sample_forwards_needed~forwards_needed"] = [
            prog["counters"].get("rollout.sample_forwards_needed"),
            getattr(run, "forwards_needed", None)]
    if by["train.step"]:
        out["train.prepare~prepare"] = [dev("train.prepare", any_tag=True),
                                        hook("prepare", any_tag=True)]
        fb = _children_ms(prog, "train.step", None,
                          ("train.forward", "train.backward"))
        out["train.forward+backward~fwd_bwd"] = [
            median(fb or []), hook("fwd_bwd", any_tag=True)]
    return out
