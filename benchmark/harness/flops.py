"""Operations the model's equations need, and the card's published peaks.

`forward_flops` counts the dense layers of one forward of the AdaptiGraph
GNN (the terms of the port's tools/profile_plan.forward_ops, copied) on
the VALID nodes and edges of the graphs it is given: node-side layers run
on the valid objects and the pusher or end-effector points, edge-side
layers on the valid edges, the motion head on the valid objects. Padded
node slots and empty edge slots add nothing, so a program that stops
computing them does its work faster and reads no higher than the work
needed. Gathers, aggregations, additions and activations are not counted:
they are not products, and a one-hot product that stands in for a gather
is the program's choice, not the model's.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def forward_flops(nodes: float, objects: float, edges: float, nf: int,
                  particle_in: int, relation_in: int, pstep: int) -> float:
    """Multiply-adds times two of one forward over graphs holding `nodes`
    valid nodes (objects and tool points), `objects` valid objects and
    `edges` valid edges in all."""
    return 2.0 * (nodes * (particle_in * nf + 2 * nf * nf)
                  + edges * (relation_in * nf + 2 * nf * nf)
                  + pstep * (edges * 3 * nf * nf + nodes * 2 * nf * nf)
                  + objects * (2 * nf * nf + nf * 3))


def share_of_peak(flops: float, seconds: float, dtype: str) -> float:
    """flops over seconds as a percentage of the card's published peak."""
    return 100.0 * flops / seconds / PEAK_FLOPS[dtype]
