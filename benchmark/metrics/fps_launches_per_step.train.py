"""Runtime launch calls (kernels, copies, sets) that the host issued inside
the program's prepare.fps spans over the profiled chunk, a step."""

from harness import program


def read(trace):
    got = program.metrics(trace.program, trace.run)
    return got.get("fps_launches_per_step.train")
