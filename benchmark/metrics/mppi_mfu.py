"""The planning window's model work against the card: the float32
operations the model's equations need for the window's pushes (each sample's
own repeats, valid nodes and edges only; harness/flops.py) over the window's
wall time, as a percentage of one H100 SXM's 67 TFLOP/s."""


def read(trace):
    if not trace.run.flops():
        return None
    return trace.run.mfu(trace.window["wall_s"])
