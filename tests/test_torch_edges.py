"""Port parity: the radius-graph builders (ops/edges.py) and the host FPS
(utils/host_fps.py) against the JAX package's.

Every case is held exactly: receivers, senders and the valid mask of all
four builders and the incidence matrices equal JAX's array for array, and
the FPS index sequences equal JAX's (whose loop runs natively in
libfps.so). Cases: random states and a lattice with exact distance ties,
masked rows, tool rows with connect_tools_all on and off and
tools_only_when_near on and off, the batch forms with a radius per sample,
and a graph that overflows max_edges (row-major truncation).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.ops import edges as je
from adaptigraph_tpu.utils import host_fps as jfps
from adaptigraph_torch.ops import edges as te
from adaptigraph_torch.utils import host_fps as tfps


def _scene(kind, seed, n=48, n_tool=3):
    """(states (N, 3), mask, tool_mask) numpy: random points or a lattice
    of spacing 0.1 (many exactly equal distances), a few rows masked out,
    the last n_tool rows tools (one of them masked out too)."""
    rng = np.random.RandomState(seed)
    if kind == "lattice":
        g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(3),
                                 indexing="ij"), -1).reshape(-1, 3)
        states = (g * 0.1).astype(np.float32)
        n = len(states)
    else:
        states = (rng.randn(n, 3) * 0.3).astype(np.float32)
    mask = rng.rand(n) > 0.15
    tool = np.zeros(n, bool)
    tool[n - n_tool:] = True
    mask[n - n_tool:] = True
    mask[n - 1] = False
    return states, mask, tool


def _radius(kind):
    return 0.25 if kind == "lattice" else 0.6


def _equal(j, t):
    for name, a, b in zip(("receivers", "senders", "valid"), j, t):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


_TOOL_RULES = list(itertools.product((False, True), (False, True)))


@pytest.mark.parametrize("kind", ["random", "lattice"])
@pytest.mark.parametrize("cta, near", _TOOL_RULES)
@pytest.mark.parametrize("max_edges", [1000, 60])
def test_build_edges_equals_jax(kind, cta, near, max_edges):
    states, mask, tool = _scene(kind, 0)
    kw = dict(topk=7, connect_tools_all=cta, tools_only_when_near=near,
              max_edges=max_edges)
    j = je.build_edges(jnp.asarray(states), _radius(kind), jnp.asarray(mask),
                       jnp.asarray(tool), **kw)
    t = te.build_edges(torch.as_tensor(states), _radius(kind),
                       torch.as_tensor(mask), torch.as_tensor(tool), **kw)
    _equal(j, t)
    n_edges = int(t.valid.sum())
    assert n_edges > 0
    if max_edges == 60:  # the graph overflows: the last receivers lose edges
        full = te.build_edges(torch.as_tensor(states), _radius(kind),
                              torch.as_tensor(mask), torch.as_tensor(tool),
                              **dict(kw, max_edges=1000))
        assert n_edges == 60 < int(full.valid.sum())
        assert torch.equal(full.receivers[:60], t.receivers)


@pytest.mark.parametrize("kind", ["random", "lattice"])
@pytest.mark.parametrize("cta, near", _TOOL_RULES)
def test_build_edges_slotted_equals_jax(kind, cta, near):
    states, mask, tool = _scene(kind, 1)
    kw = dict(topk=7, connect_tools_all=cta, tools_only_when_near=near,
              tool_slots=4)
    j = je.build_edges_slotted(jnp.asarray(states), _radius(kind),
                               jnp.asarray(mask), jnp.asarray(tool), **kw)
    t = te.build_edges_slotted(torch.as_tensor(states), _radius(kind),
                               torch.as_tensor(mask), torch.as_tensor(tool),
                               **kw)
    _equal(j, t)
    assert int(t.valid.sum()) > 0


def test_tools_only_when_near_gates_the_tool_edges():
    """A tool far from every object gets no edges with the gate on, and
    every object receiver's tool edge with it off."""
    states, mask, tool = _scene("random", 2)
    states[tool] += 50.0
    args = (torch.as_tensor(states), 0.6, torch.as_tensor(mask),
            torch.as_tensor(tool))
    for builder in (te.build_edges, te.build_edges_slotted):
        on = builder(*args, connect_tools_all=True, tools_only_when_near=True)
        off = builder(*args, connect_tools_all=True,
                      tools_only_when_near=False)
        to_tool = torch.as_tensor(tool)[on.senders.long()]
        assert not bool((on.valid & to_tool).any())
        to_tool = torch.as_tensor(tool)[off.senders.long()]
        assert int((off.valid & to_tool).sum()) == int(
            (mask & ~tool).sum()) * int((tool & mask).sum())


@pytest.mark.parametrize("slotted", [False, True])
@pytest.mark.parametrize("cta", [False, True])
def test_batch_forms_with_a_radius_per_sample_equal_jax(slotted, cta):
    scenes = [_scene(kind, s) for kind, s in
              (("random", 3), ("random", 4), ("lattice", 5))]
    n = min(len(s[0]) for s in scenes)
    states = np.stack([s[0][-n:] for s in scenes])
    mask = np.stack([s[1][-n:] for s in scenes])
    tool = np.stack([s[2][-n:] for s in scenes])
    radii = np.array([0.6, 0.45, 0.25], np.float32)
    if slotted:
        kw = dict(topk=6, connect_tools_all=cta, tool_slots=4)
        j = je.build_edges_slotted_batch(jnp.asarray(states), jnp.asarray(radii),
                                         jnp.asarray(mask), jnp.asarray(tool),
                                         **kw)
        t = te.build_edges_slotted_batch(torch.as_tensor(states),
                                         torch.as_tensor(radii),
                                         torch.as_tensor(mask),
                                         torch.as_tensor(tool), **kw)
    else:
        kw = dict(topk=6, connect_tools_all=cta, max_edges=300)
        j = je.build_edges_batch(jnp.asarray(states), jnp.asarray(radii),
                                 jnp.asarray(mask), jnp.asarray(tool), **kw)
        t = te.build_edges_batch(torch.as_tensor(states),
                                 torch.as_tensor(radii),
                                 torch.as_tensor(mask), torch.as_tensor(tool),
                                 **kw)
    _equal(j, t)
    counts = t.valid.sum(1)
    assert bool((counts > 0).all()) and len(set(counts.tolist())) > 1


@pytest.mark.parametrize("slotted", [False, True])
def test_edges_to_incidence_equals_jax(slotted):
    states, mask, tool = _scene("lattice", 6)
    n = len(states)
    build = "build_edges_slotted" if slotted else "build_edges"
    j = getattr(je, build)(jnp.asarray(states), 0.25, jnp.asarray(mask),
                           jnp.asarray(tool), connect_tools_all=True)
    t = getattr(te, build)(torch.as_tensor(states), 0.25,
                           torch.as_tensor(mask), torch.as_tensor(tool),
                           connect_tools_all=True)
    for a, b in zip(je.edges_to_incidence(j, n), te.edges_to_incidence(t, n)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("n_points, n", [(500, 100), (64, 64), (30, 50)])
def test_fps_with_idx_equals_jax(n_points, n):
    pts = np.random.RandomState(n_points).rand(n_points, 3)
    jp, ji = jfps.fps_with_idx(pts, n)
    tp, ti = tfps.fps_with_idx(pts, n)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("kind", ["random", "lattice"])
def test_fps_rad_idx_equals_jax(kind):
    if kind == "lattice":  # equal distances: numpy's first-index ties
        g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1)
        pts = g.reshape(-1, 3).astype(np.float64) * 0.1
    else:
        pts = np.random.RandomState(9).rand(400, 3)
    j_rng, t_rng = np.random.RandomState(42), np.random.RandomState(42)
    for _ in range(3):  # the start is drawn from the caller's stream
        _, ji = jfps.fps_rad_idx(pts, 0.2, j_rng)
        _, ti = tfps.fps_rad_idx(pts, 0.2, t_rng)
        np.testing.assert_array_equal(ti, ji)
    assert len(ti) > 10
