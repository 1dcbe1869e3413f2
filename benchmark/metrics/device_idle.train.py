"""The share of the profiled segment (the window's third chunk) in which
no operation ran on the card, from torch.profiler."""


def read(trace):
    p = trace.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]
