"""ms of one graph preparation at the cell's batch
(dynamics.dataset.prepare_graph_batch: FPS, padding, noise and rotation,
edges), from the card reaching its first kernel to its last (CUDA events):
the host's launch pace where it is slower than the card. The median over the
traced window's steps."""

import statistics


def read(trace):
    ms = [m for m, _ in trace.spans.get("prepare", [])]
    return statistics.median(ms) if ms else None
