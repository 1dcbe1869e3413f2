"""Device ms of one slotted edge rebuild over one chunk's states (the
rollout's ops.edges.build_edges_slotted_batch): the median over the traced
window's rebuilds at the chunk's batch, timed by CUDA events."""

import statistics


def read(trace):
    ms = [m for m, b in trace.spans.get("edges", []) if b == trace.run.chunk]
    return statistics.median(ms) if ms else None
