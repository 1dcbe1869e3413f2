"""The share of the rollout's edge slots that hold an edge: the program's
counters rollout.valid_edges over rollout.edge_slots, over the traced
window's edge rebuilds."""

from harness import program


def read(trace):
    got = program.metrics(trace.program, trace.run)
    return got.get("valid_edge_share.mppi")
