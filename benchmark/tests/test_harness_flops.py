"""The operation count: valid nodes and edges only, padding adds nothing."""

from __future__ import annotations

import torch

from harness.flops import forward_flops, share_of_peak
from reference.edges import radius_edges


def _count(pos, valid, tool, radius=0.5, topk=10):
    g, r, s = radius_edges(pos, radius, valid, tool, topk)
    return int(valid.sum()), int((valid & ~tool).sum()), int(g.numel())


def test_a_hand_built_graph():
    # three objects on a line 0.3 apart and one tool 0.3 past the last:
    # within 0.5 each object reaches itself and its neighbours; the tool
    # pairs with no tool, itself included: 3 self edges + 3 pairs both
    # ways = 9
    pos = torch.tensor([[[0.0, 0, 0], [0.3, 0, 0], [0.6, 0, 0],
                         [0.9, 0, 0]]])
    valid = torch.ones((1, 4), dtype=torch.bool)
    tool = torch.tensor([[False, False, False, True]])
    nodes, objects, edges = _count(pos, valid, tool)
    assert (nodes, objects, edges) == (4, 3, 9)
    nf, p_in, r_in, pstep = 150, 6, 17, 3
    by_hand = 2 * (4 * (6 * 150 + 2 * 150 * 150)
                   + 9 * (17 * 150 + 2 * 150 * 150)
                   + 3 * (9 * 3 * 150 * 150 + 4 * 2 * 150 * 150)
                   + 3 * (2 * 150 * 150 + 150 * 3))
    assert forward_flops(nodes, objects, edges, nf, p_in, r_in,
                         pstep) == by_hand


def test_padding_adds_nothing():
    pos = torch.tensor([[[0.0, 0, 0], [0.3, 0, 0], [0.6, 0, 0],
                         [0.9, 0, 0]]])
    valid = torch.ones((1, 4), dtype=torch.bool)
    tool = torch.tensor([[False, False, False, True]])
    pad = torch.zeros((1, 6, 3))
    pos_p = torch.cat([pos[:, :3], pad, pos[:, 3:]], 1)
    valid_p = torch.cat([valid[:, :3], torch.zeros((1, 6), dtype=torch.bool),
                         valid[:, 3:]], 1)
    tool_p = torch.cat([tool[:, :3], torch.zeros((1, 6), dtype=torch.bool),
                        tool[:, 3:]], 1)
    assert _count(pos_p, valid_p, tool_p) == _count(pos, valid, tool)


def test_share_of_peak():
    assert share_of_peak(67e12, 1.0, "float32") == 100.0
    assert abs(share_of_peak(6.7e12, 2.0, "float32") - 5.0) < 1e-12
