"""Device ms of the relation MLP in one forward over one chunk's graphs: the
program's model.relation_mlp spans (the relation encoder and each
propagator pass) inside each rollout.forward at the chunk's batch, summed
a forward; the median over the traced window's forwards."""

from harness import program


def read(trace):
    got = program.metrics(trace.program, trace.run)
    return got.get("relation_mlp_ms.mppi")
