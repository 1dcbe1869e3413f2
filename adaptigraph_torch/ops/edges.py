"""Radius-graph construction as fixed-size edge lists: the port of
adaptigraph_tpu/ops/edges.py.

Each builder emits a fixed-capacity edge list (receivers, senders, valid)
that the dynamics model gathers from and aggregates into. `build_edges`
enumerates edges in row-major order over the receiver x sender adjacency
(the reference's ``adj_matrix.nonzero()``) and truncates to `max_edges`;
`build_edges_slotted` gives receiver i the slots of its top-k candidates
(see its docstring). The batch forms take a leading batch dimension
natively (one set of launches for the whole batch, where JAX vmaps); the
single-graph forms are the batch forms at B = 1.

Everything runs on the tensors' device. Ties keep `lax.top_k`'s order (the
lower index first) by stable sorts, and squared distances are rounded as
XLA rounds `sum(d * d, -1)` on the CPU (engine.neighbors.sq_dist_fma), so
that on the CPU the edge lists equal the JAX package's exactly, lattice
ties and cutoff crossings included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from adaptigraph_torch.engine.neighbors import sq_dist_fma, top_k_smallest

_BIG = 1e10


class EdgeSet(NamedTuple):
    """Fixed-capacity directed edge list. Padded entries have valid=False
    and receiver=sender=0 (safe to gather; masked before aggregation)."""

    receivers: torch.Tensor  # (..., max_edges) int32
    senders: torch.Tensor  # (..., max_edges) int32
    valid: torch.Tensor  # (..., max_edges) bool

    @property
    def max_edges(self) -> int:
        return self.receivers.shape[-1]


def _batch_inputs(states, adj_thresh, mask, tool_mask):
    """Tensors on the states' device: states (B, N, 3), the squared radius
    (B,), masks (B, N) bool."""
    states = torch.as_tensor(states)
    dev, b = states.device, states.shape[0]
    thresh = torch.as_tensor(adj_thresh, dtype=states.dtype, device=dev)
    thresh = torch.broadcast_to(thresh, (b,))
    mask = torch.as_tensor(mask, device=dev).bool()
    tool_mask = torch.as_tensor(tool_mask, device=dev).bool()
    return states, thresh * thresh, mask, tool_mask


def _masked_sq_dist(states, mask, tool_mask):
    """(B, N, N) squared distances, _BIG where either end is masked out or
    both ends are tools."""
    dis = sq_dist_fma(states[:, :, None, :] - states[:, None, :, :])
    pair_ok = mask[:, :, None] & mask[:, None, :]
    tool_pair = tool_mask[:, :, None] & tool_mask[:, None, :]
    return torch.where(pair_ok & ~tool_pair, dis, torch.full_like(dis, _BIG))


def _adjacency(states, thresh2, mask, tool_mask, topk: int,
               connect_tools_all: bool, tools_only_when_near: bool):
    """(B, N, N) bool adjacency, receiver-major, with the reference's
    rules: the squared-distance threshold, each receiver's topk nearest,
    no tool-tool edges; with connect_tools_all no tool receivers and every
    object receiver joined to every tool sender (with
    `tools_only_when_near`, only when some tool receiver already had an
    object sender within the radius)."""
    b, n, _ = states.shape
    dis = _masked_sq_dist(states, mask, tool_mask)
    adj = dis < thresh2[:, None, None]
    _, topk_idx = top_k_smallest(dis, min(n, topk))
    in_topk = torch.zeros_like(adj).scatter_(2, topk_idx, True)
    adj = adj & in_topk
    if connect_tools_all:
        tool_pair = tool_mask[:, :, None] & tool_mask[:, None, :]
        tool_recv = tool_mask[:, :, None] & mask[:, None, :]
        obj_recv_tool_send = mask[:, :, None] & tool_mask[:, None, :]
        if tools_only_when_near:
            tool_obj = tool_mask[:, :, None] & ~tool_mask[:, None, :]
            near = (adj & tool_obj).flatten(1).any(1)[:, None, None]
        else:
            near = torch.ones((b, 1, 1), dtype=torch.bool, device=adj.device)
        adj = adj & ~tool_recv
        adj = torch.where(obj_recv_tool_send, near, adj)
        adj = adj & ~tool_pair
        # connected tool senders must themselves be valid particles
        adj = adj & mask[:, None, :] & mask[:, :, None]
    return adj


def build_edges_batch(states, adj_thresh, mask, tool_mask, topk: int = 10,
                      connect_tools_all: bool = False,
                      tools_only_when_near: bool = True,
                      max_edges: int = 1000) -> EdgeSet:
    """The radius graph of each of B state sets, (B, max_edges) lists.

    states (B, N, 3) (objects then tools, padded); adj_thresh the
    connection radius, a scalar or (B,) per sample; mask / tool_mask (B, N)
    valid-particle and tool-particle masks; topk, connect_tools_all,
    max_edges the reference config's dataset.topk, connect_tool_all and
    max_nR. Edges come in row-major (receiver-major) order, truncated to
    `max_edges`, as the reference pads to max_nR."""
    states, thresh2, mask, tool_mask = _batch_inputs(states, adj_thresh, mask,
                                                     tool_mask)
    n = states.shape[1]
    adj = _adjacency(states, thresh2, mask, tool_mask, topk,
                     connect_tools_all, tools_only_when_near)
    flat = adj.flatten(1)
    # a stable sort of the negated mask: the edges first, in row-major order
    order = torch.argsort((~flat).to(torch.uint8), dim=1,
                          stable=True)[:, :max_edges]
    valid = torch.gather(flat, 1, order)
    zero = torch.zeros_like(order)
    recv = torch.where(valid, order // n, zero).to(torch.int32)
    send = torch.where(valid, order % n, zero).to(torch.int32)
    return EdgeSet(recv, send, valid)


def build_edges(states, adj_thresh, mask, tool_mask, topk: int = 10,
                connect_tools_all: bool = False,
                tools_only_when_near: bool = False,
                max_edges: int = 1000) -> EdgeSet:
    """The radius graph of one state set: `build_edges_batch` on states
    (N, 3), masks (N,) and a scalar radius; (max_edges,) lists."""
    e = build_edges_batch(torch.as_tensor(states)[None], adj_thresh,
                          torch.as_tensor(mask)[None],
                          torch.as_tensor(tool_mask)[None], topk=topk,
                          connect_tools_all=connect_tools_all,
                          tools_only_when_near=tools_only_when_near,
                          max_edges=max_edges)
    return EdgeSet(*(x[0] for x in e))


def build_edges_slotted_batch(states, adj_thresh, mask, tool_mask,
                              topk: int = 10, connect_tools_all: bool = False,
                              tools_only_when_near: bool = True,
                              tool_slots: int = 8) -> EdgeSet:
    """The radius graph of each of B state sets as a SLOTTED edge list:
    slot (i, k) holds receiver i's k-th nearest candidate, with no
    row-major compaction (so no sort over the N x N adjacency).

    The valid edge set equals `build_edges`' (the same radius, per-receiver
    topk and tool rules); only the order and padding differ, which message
    passing cannot see. Capacity is N * topk (+ N * tool_slots with
    connect_tools_all) instead of max_nR, and nothing is dropped where a
    graph would overflow max_nR. tool_slots: the cap on tool senders in the
    connect_tools_all block (at least the scene's tool count)."""
    states, thresh2, mask, tool_mask = _batch_inputs(states, adj_thresh, mask,
                                                     tool_mask)
    b, n, _ = states.shape
    dev = states.device
    dis = _masked_sq_dist(states, mask, tool_mask)
    k = min(n, topk)
    top_dis, topk_idx = top_k_smallest(dis, k)  # (B, N, K)
    slot_valid = top_dis < thresh2[:, None, None]
    recv = torch.arange(n, device=dev)[None, :, None].expand(b, n, k)
    send = topk_idx

    if connect_tools_all:
        send_is_tool = torch.gather(tool_mask, 1,
                                    send.flatten(1)).view(b, n, k)
        if tools_only_when_near:
            tool_recv_slot = tool_mask[:, :, None] & slot_valid
            near = (tool_recv_slot & ~send_is_tool).flatten(1).any(1)
        else:
            near = torch.ones((b,), dtype=torch.bool, device=dev)
        # drop tool receivers and tool senders from the radius slots
        slot_valid = slot_valid & ~tool_mask[:, :, None] & ~send_is_tool
        # object receiver -> every tool sender (gated by `near`): the tools
        # first, in index order (lax.top_k of the tool mask)
        ts = min(n, tool_slots)
        tidx = torch.argsort((~tool_mask).to(torch.uint8), dim=1,
                             stable=True)[:, :ts]  # (B, TS)
        tscore = torch.gather(tool_mask, 1, tidx)
        t_send = tidx[:, None, :].expand(b, n, ts)
        t_valid = (tscore[:, None, :] & mask[:, :, None]
                   & ~tool_mask[:, :, None] & near[:, None, None]
                   & torch.gather(mask, 1, tidx)[:, None, :])
        t_recv = torch.arange(n, device=dev)[None, :, None].expand(b, n, ts)
        recv = torch.cat([recv, t_recv], dim=2)
        send = torch.cat([send, t_send], dim=2)
        slot_valid = torch.cat([slot_valid, t_valid], dim=2)

    valid = slot_valid.flatten(1)
    zero = torch.zeros_like(send.flatten(1))
    recv = torch.where(valid, recv.flatten(1), zero).to(torch.int32)
    send = torch.where(valid, send.flatten(1), zero).to(torch.int32)
    return EdgeSet(recv, send, valid)


def build_edges_slotted(states, adj_thresh, mask, tool_mask, topk: int = 10,
                        connect_tools_all: bool = False,
                        tools_only_when_near: bool = False,
                        tool_slots: int = 8) -> EdgeSet:
    """`build_edges_slotted_batch` for one state set (N, 3)."""
    e = build_edges_slotted_batch(
        torch.as_tensor(states)[None], adj_thresh,
        torch.as_tensor(mask)[None], torch.as_tensor(tool_mask)[None],
        topk=topk, connect_tools_all=connect_tools_all,
        tools_only_when_near=tools_only_when_near, tool_slots=tool_slots)
    return EdgeSet(*(x[0] for x in e))


def edges_to_incidence(edges: EdgeSet, n_nodes: int):
    """Dense (..., max_edges, N) one-hot Rr, Rs of valid edges: the
    reference's incidence representation, for parity checks."""
    vals = edges.valid.to(torch.float32)[..., None]

    def one_hot(idx):
        out = torch.zeros(tuple(idx.shape) + (n_nodes,), dtype=torch.float32,
                          device=idx.device)
        return out.scatter_add_(-1, idx.long()[..., None], vals)

    return one_hot(edges.receivers), one_hot(edges.senders)
