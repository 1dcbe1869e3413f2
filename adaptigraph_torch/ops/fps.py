"""Farthest-point sampling on the tensors' device: the port of
adaptigraph_tpu/ops/fps.py, with batched forms over (B, N) for the
training graph preparation.

FPS is sequential: each of the n - 1 selections is one masked argmax and
one distance update over every point. The batch forms run that loop once
for the whole batch (about 16 launches a selection, whatever B is); the
single-cloud forms are the batch forms at B = 1.

Fixed shape, as in JAX: invalid points are masked (distance -1e10, never
selected), and radius-stop sampling returns a (max_n,) index buffer and a
validity mask instead of a variable-length list. Distances are rounded as
XLA rounds `norm(points - p, -1)` on the CPU (the squared length contracted
into fused multiply-adds, engine.neighbors.sq_dist_fma, then the sqrt), and
`torch.argmax` takes the first of equal maxima as `jnp.argmax` does, so on
the CPU the index lists equal the JAX package's, lattice ties included.

Randomness is passed in: the two random starts of `fps_subsample` are
ranks (the r-th valid point), drawn by the caller (`start_ranks`).
"""

from __future__ import annotations

import torch

from adaptigraph_torch.engine.neighbors import sq_dist_fma

_BIG = 1e10


def _dist(points, centre):
    """(B, N) float32 distances of points (B, N, 3) to centre (B, 3)."""
    return torch.sqrt(sq_dist_fma(points - centre[:, None, :]))


def _rows(b, device):
    return torch.arange(b, device=device)


def farthest_point_sampling_batch(points, n_samples: int, start_idx,
                                  valid=None):
    """Classic FPS of each of B clouds: exactly `n_samples` indices.

    points (B, N, 3); start_idx (B,) the first sample of each cloud; valid
    an optional (B, N) mask (invalid points are never selected).

    Returns idx (B, n_samples) int32 and maxdist (B, n_samples), the
    farthest remaining distance before each selection (maxdist[:, 0] =
    inf), from which the radius-stop form derives validity."""
    points = torch.as_tensor(points, dtype=torch.float32)
    b, n, _ = points.shape
    dev = points.device
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    rows = _rows(b, dev)
    start = torch.as_tensor(start_idx, device=dev).long().expand(b)
    neg = torch.tensor(-_BIG, dtype=torch.float32, device=dev)
    dist = torch.where(valid, _dist(points, points[rows, start]), neg)
    idx, far = [start], [torch.full((b,), float("inf"), device=dev)]
    for _ in range(n_samples - 1):
        nxt = torch.argmax(dist, dim=1)
        far.append(dist[rows, nxt])
        d_new = torch.where(valid, _dist(points, points[rows, nxt]), neg)
        dist = torch.minimum(dist, d_new)
        idx.append(nxt)
    return torch.stack(idx, 1).to(torch.int32), torch.stack(far, 1)


def fps_radius_batch(points, radius, max_n: int, start_idx, valid=None):
    """Radius-stop FPS of each of B clouds: sample until the farthest
    remaining point is within `radius` (a scalar or (B,)) of the sampled
    set (the reference's fps_rad_idx), fixed shape.

    Returns (idx (B, max_n), keep (B, max_n) bool): keep[:, i] is True iff
    sample i would have been emitted by the variable-length loop."""
    idx, maxdist = farthest_point_sampling_batch(points, max_n, start_idx,
                                                 valid)
    radius = torch.as_tensor(radius, dtype=torch.float32,
                             device=maxdist.device)
    if radius.dim() == 1:
        radius = radius[:, None]
    return idx, maxdist > radius


def _stable_valid_first(mask):
    """Indices of `mask`'s True entries first, each group in index order
    (jnp.argsort(~mask), which is stable)."""
    return torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)


def start_ranks(u, nvalid, max_n: int):
    """The two start ranks of `fps_subsample_batch` from uniform draws u
    (B, 2) in [0, 1): the first uniform over the nvalid valid points, the
    second over the min(nvalid, max_n) points stage 1 keeps (as JAX draws
    them with randint over the same counts). (B, 2) int64."""
    nvalid = torch.as_tensor(nvalid, device=u.device).long()
    counts = torch.stack([nvalid.clamp(min=1),
                          nvalid.clamp(max=max_n).clamp(min=1)], dim=1)
    ranks = torch.floor(u.double() * counts).long()
    return torch.minimum(ranks, counts - 1)


def fps_subsample_batch(points, max_n: int, radius, ranks, valid=None):
    """The full reference recipe (src/dynamics/dataset/graph.py:8-36) for
    each of B clouds: FPS from a random start to `max_n`, then radius-stop
    FPS from a second random start over the downsampled set; the index
    maps composed.

    points (B, N, 3); radius a scalar or (B,); ranks (B, 2) the starts as
    ranks among the valid points (stage 1) and among the points stage 1
    kept (stage 2), as `start_ranks` draws them; valid (B, N).

    Returns idx (B, max_n) indices into each cloud and keep (B, max_n),
    the kept samples first in selection order; the slots beyond them alias
    the first sample, so gathered positions stay finite."""
    points = torch.as_tensor(points, dtype=torch.float32)
    b, n, _ = points.shape
    dev = points.device
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    ranks = torch.as_tensor(ranks, device=dev).long()
    nvalid = valid.sum(1)

    # stage 1: FPS to max_n over the raw cloud from the r1-th valid point
    start1 = torch.gather(_stable_valid_first(valid), 1, ranks[:, :1])[:, 0]
    idx1, _ = farthest_point_sampling_batch(points, max_n, start1, valid)
    idx1l = idx1.long()
    sub = torch.gather(points, 1, idx1l[:, :, None].expand(b, max_n, 3))
    # stage-1 duplicates appear when nvalid < max_n: masked out of stage 2
    stage1_keep = (torch.arange(max_n, device=dev)[None, :]
                   < nvalid.clamp(max=max_n)[:, None])
    sub_valid = torch.gather(valid, 1, idx1l) & stage1_keep

    # stage 2: radius-stop FPS over the subset from the r2-th kept point
    start2 = torch.gather(_stable_valid_first(sub_valid), 1,
                          ranks[:, 1:])[:, 0]
    idx2, keep = fps_radius_batch(sub, radius, max_n, start2, sub_valid)
    idx2l = idx2.long()
    keep = keep & torch.gather(sub_valid, 1, idx2l)
    final = torch.gather(idx1, 1, idx2l)

    # compact: the kept samples first, in selection order
    pos = _stable_valid_first(keep)
    final = torch.gather(final, 1, pos)
    keep = torch.gather(keep, 1, pos)
    return torch.where(keep, final, final[:, :1]), keep


def farthest_point_sampling(points, n_samples: int, start_idx=0, valid=None):
    """`farthest_point_sampling_batch` of one cloud (N, 3): (idx, maxdist),
    each (n_samples,)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    idx, far = farthest_point_sampling_batch(
        points[None], n_samples, torch.as_tensor(start_idx).reshape(1),
        None if valid is None else torch.as_tensor(valid)[None])
    return idx[0], far[0]


def fps_radius(points, radius, max_n: int, start_idx=0, valid=None):
    """`fps_radius_batch` of one cloud (N, 3): (idx, keep), each
    (max_n,)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    idx, keep = fps_radius_batch(
        points[None], radius, max_n, torch.as_tensor(start_idx).reshape(1),
        None if valid is None else torch.as_tensor(valid)[None])
    return idx[0], keep[0]


def fps_subsample(points, max_n: int, radius, ranks=None, valid=None,
                  generator=None):
    """`fps_subsample_batch` of one cloud (N, 3). ranks: the two start
    ranks (2,); when None they are drawn from `generator` (a
    torch.Generator on the CPU; the global stream when None). Returns
    (idx, keep), each (max_n,)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    v = None if valid is None else torch.as_tensor(valid)[None]
    if ranks is None:
        nvalid = points.shape[0] if v is None else int(v.sum())
        u = torch.rand((1, 2), generator=generator)
        ranks = start_ranks(u, torch.tensor([nvalid]), max_n)
    idx, keep = fps_subsample_batch(
        points[None], max_n, radius, torch.as_tensor(ranks).reshape(1, 2), v)
    return idx[0], keep[0]
