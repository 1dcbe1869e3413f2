"""The share of the profiled chunk's device idle that began while the host
was inside the graph preparation (the program's train.prepare span and
its children prepare.fps and prepare.edges)."""

from harness import program


def read(trace):
    got = program.metrics(trace.program, trace.run)
    return got.get("prepare_idle_share.train")
