"""The training window's model work against the card: the unrolled
forward and backward (three forwards' worth for each of the n_future
predictions) on the valid nodes and edges of the followed steps' graphs,
times the window's steps, over the window's wall time, as a percentage of one
H100 SXM's 67 TFLOP/s float32."""


def read(trace):
    if not trace.run.flops():
        return None
    return trace.run.mfu(trace.window["wall_s"])
