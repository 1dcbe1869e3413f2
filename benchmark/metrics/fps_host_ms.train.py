"""Host ms of farthest-point sampling in one graph preparation: the
program's prepare.fps span, from its start to its end on the host; the
median over the traced window's steps."""

from harness import program


def read(trace):
    got = program.metrics(trace.program, trace.run)
    return got.get("fps_host_ms.train")
