"""The share of the rollout's sample forwards that the pushes need: the
program's counters rollout.sample_forwards_needed over
rollout.sample_forwards_run, over the traced window."""

from harness import program


def read(trace):
    got = program.metrics(trace.program, trace.run)
    return got.get("useful_forward_share.mppi")
