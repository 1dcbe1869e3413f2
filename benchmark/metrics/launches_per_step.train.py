"""Device operations (kernels, copies, sets) a train step: those
torch.profiler saw in the profiled chunk over its steps."""


def read(trace):
    p = trace.profile
    steps = getattr(trace.run, "steps_profiled", 0)
    if not p or not p["device_ops"] or not steps:
        return None
    return p["device_ops"] / steps
