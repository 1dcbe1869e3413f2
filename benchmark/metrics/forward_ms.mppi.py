"""Device ms of one model forward over one chunk's graphs: the median over
the traced window's forwards at the chunk's batch, each timed by CUDA events
that the harness's forward hooks record."""

import statistics


def read(trace):
    ms = [m for m, b in trace.spans.get("forward", []) if b == trace.run.chunk]
    return statistics.median(ms) if ms else None
