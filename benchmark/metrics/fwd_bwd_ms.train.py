"""ms of one step's unrolled forward and backward: from the end of the
step's graph preparation to the start of its Adam update (CUDA events). The
median over the traced window's steps."""

import statistics


def read(trace):
    ms = [m for m, _ in trace.spans.get("fwd_bwd", [])]
    return statistics.median(ms) if ms else None
