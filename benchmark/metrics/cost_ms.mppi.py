"""Device ms of scoring one whole population (the evaluator composed from
planning.costs: chunked_cost at the task's chunk): the median over the traced
window's populations, timed by CUDA events."""

import statistics


def read(trace):
    ms = [m for m, n in trace.spans.get("cost", []) if n == trace.run.n_sample]
    return statistics.median(ms) if ms else None
