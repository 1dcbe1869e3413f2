"""Device ms of the model's incidence work in one forward over one chunk's
graphs: the program's spans model.incidence + model.gather +
model.aggregate inside each rollout.forward at the chunk's batch, summed a
forward; the median over the traced window's forwards."""

from harness import program


def read(trace):
    got = program.metrics(trace.program, trace.run)
    return got.get("incidence_ms.mppi")
