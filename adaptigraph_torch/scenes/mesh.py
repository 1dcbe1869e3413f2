"""Triangle-mesh asset toolkit: OBJ import, transforms, AABB-tree queries,
voxelization, signed-distance grids, and mesh -> soft-body particle assets.

The port's own copy of adaptigraph_tpu/scenes/mesh.py, a numpy module
(host-side: assets are built once per episode), so that the port imports
nothing of the JAX package; `soft_from_mesh` takes `greedy_ball_cover`
from the port's scenes/build.py. The same calls give the same arrays.

  * OBJ import / transform / normalize   (core/mesh.cpp `ImportMeshFromObj`,
    `Mesh::Transform`, `Mesh::Normalize`).
  * AABB tree (closest point / raycast)  (core/aabbtree.cpp).
  * voxelization (x-ray parity fill)     (core/voxelize.cpp `Voxelize`).
  * signed-distance grid                 (core/sdf.cpp `MakeSDF`: unsigned
    distance to the surface, sign from voxel occupancy).
  * `sample_mesh` + `soft_from_mesh`     (flexExtSoft.cpp:394 `SampleMesh`
    and flexExtSoft.cpp:510 `NvFlexExtCreateSoftFromMesh`: particles ->
    shape-matching clusters by greedy ball cover -> link springs within
    linkRadius -> optional global cluster).

The fixed-size arrays it makes feed `engine.state.make_clusters` and
`make_springs`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


# ---------------------------------------------------------------------------
# mesh container + OBJ io
# ---------------------------------------------------------------------------


class TriMesh(NamedTuple):
    vertices: np.ndarray  # (V, 3) f32
    faces: np.ndarray  # (F, 3) i32

    @property
    def bounds(self):
        return self.vertices.min(0), self.vertices.max(0)

    def transformed(self, matrix: np.ndarray) -> "TriMesh":
        """Apply a 4x4 (or 3x3 linear) homogeneous transform
        (core/mesh.cpp `Mesh::Transform`)."""
        m = np.asarray(matrix, dtype=np.float32)
        v = self.vertices
        if m.shape == (3, 3):
            v = v @ m.T
        elif m.shape == (4, 4):
            v = v @ m[:3, :3].T + m[:3, 3]
        else:
            raise ValueError(f"expected 3x3 or 4x4 matrix, got {m.shape}")
        return TriMesh(v.astype(np.float32), self.faces)

    def translated(self, t) -> "TriMesh":
        return TriMesh(self.vertices + np.asarray(t, dtype=np.float32), self.faces)

    def scaled(self, s) -> "TriMesh":
        return TriMesh(self.vertices * np.asarray(s, dtype=np.float32), self.faces)

    def normalized(self) -> "TriMesh":
        """Uniform-rescale the longest extent to 1 and move min corner to the
        origin (core/mesh.cpp `Mesh::Normalize`)."""
        lo, hi = self.bounds
        scale = 1.0 / max(float((hi - lo).max()), 1e-12)
        return TriMesh(((self.vertices - lo) * scale).astype(np.float32), self.faces)

    def triangles(self) -> np.ndarray:
        """(F, 3, 3) corner positions."""
        return self.vertices[self.faces]


def import_obj(path: str) -> TriMesh:
    """Minimal Wavefront OBJ reader: `v` and `f` records, fan-triangulated
    polygons, 1-based and negative indices (core/mesh.cpp ImportMeshFromObj).
    Texture/normal references (`f v/vt/vn`) are ignored."""
    verts: list = []
    faces: list = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(np.asarray(verts, dtype=np.float32),
                   np.asarray(faces, dtype=np.int32).reshape(-1, 3))


def export_obj(mesh: TriMesh, path: str) -> None:
    with open(path, "w") as fh:
        for v in mesh.vertices:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in mesh.faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


# ---------------------------------------------------------------------------
# procedural primitives (test/scene assets; replaces shipped .obj files)
# ---------------------------------------------------------------------------


def make_box_mesh(half_extents=(0.5, 0.5, 0.5)) -> TriMesh:
    h = np.asarray(half_extents, dtype=np.float32)
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                       dtype=np.float32) * h
    # 12 triangles, outward-facing winding
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return TriMesh(corners, np.asarray(faces, dtype=np.int32))


def make_cylinder_mesh(length: float, radius: float, n_seg: int = 24,
                       n_len: int = 8, axis: int = 0) -> TriMesh:
    """Closed cylinder along `axis` (default +x), centered at the origin —
    a procedural stand-in for the reference's shipped rope.obj tube."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    xs = np.linspace(-length / 2, length / 2, n_len + 1)
    ring = np.stack([np.cos(ang), np.sin(ang)], 1) * radius  # (n_seg, 2)
    verts = [np.concatenate([np.full((n_seg, 1), x), ring], 1) for x in xs]
    verts = np.concatenate(verts, 0)
    faces = []
    for i in range(n_len):
        for j in range(n_seg):
            a = i * n_seg + j
            b = i * n_seg + (j + 1) % n_seg
            c = (i + 1) * n_seg + j
            d = (i + 1) * n_seg + (j + 1) % n_seg
            faces += [[a, b, d], [a, d, c]]
    # end caps via center fans
    c0 = len(verts)
    verts = np.concatenate([verts, [[xs[0], 0, 0], [xs[-1], 0, 0]]], 0)
    for j in range(n_seg):
        faces.append([c0, (j + 1) % n_seg, j])  # -x cap
        base = n_len * n_seg
        faces.append([c0 + 1, base + j, base + (j + 1) % n_seg])  # +x cap
    verts = verts.astype(np.float32)
    if axis != 0:
        order = {1: [1, 0, 2], 2: [2, 1, 0]}[axis]
        verts = verts[:, order]
    return TriMesh(verts, np.asarray(faces, dtype=np.int32))


def make_icosphere(radius: float = 0.5, subdiv: int = 2) -> TriMesh:
    t = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float32)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 dtype=np.int32)
    for _ in range(subdiv):
        edge_mid: dict = {}
        verts = list(v)
        new_f = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                edge_mid[key] = len(verts)
                verts.append((verts[a] + verts[b]) / 2)
            return edge_mid[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_f += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts, dtype=np.float32)
        f = np.asarray(new_f, dtype=np.int32)
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius
    return TriMesh(v.astype(np.float32), f)


# ---------------------------------------------------------------------------
# point-triangle distance (vectorized Ericson closest-point)
# ---------------------------------------------------------------------------


def _closest_on_triangles(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Closest points on triangles `tri` (M, 3, 3) to points `p` (M, 3),
    elementwise (one triangle per point). Region-based projection."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab, ac, ap = b - a, c - a, p - a
    d1 = np.einsum("ij,ij->i", ab, ap)
    d2 = np.einsum("ij,ij->i", ac, ap)
    bp = p - b
    d3 = np.einsum("ij,ij->i", ab, bp)
    d4 = np.einsum("ij,ij->i", ac, bp)
    cp = p - c
    d5 = np.einsum("ij,ij->i", ab, cp)
    d6 = np.einsum("ij,ij->i", ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom = np.where(vb + vc + va == 0, 1.0, va + vb + vc)
    v = vb / denom
    w = vc / denom
    out = a + v[:, None] * ab + w[:, None] * ac  # interior default
    # edge/vertex regions override in priority order
    t_bc = np.clip((d4 - d3) / np.where(d4 - d3 + d5 - d6 == 0, 1.0, (d4 - d3) + (d5 - d6)), 0, 1)
    m = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    out = np.where(m[:, None], b + t_bc[:, None] * (c - b), out)
    t_ac = np.clip(d2 / np.where(d2 - d6 == 0, 1.0, d2 - d6), 0, 1)
    m = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    out = np.where(m[:, None], a + t_ac[:, None] * ac, out)
    t_ab = np.clip(d1 / np.where(d1 - d3 == 0, 1.0, d1 - d3), 0, 1)
    m = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    out = np.where(m[:, None], a + t_ab[:, None] * ab, out)
    m = (d6 >= 0) & (d5 <= d6)
    out = np.where(m[:, None], c, out)
    m = (d3 >= 0) & (d4 <= d3)
    out = np.where(m[:, None], b, out)
    m = (d1 <= 0) & (d2 <= 0)
    out = np.where(m[:, None], a, out)
    return out


# ---------------------------------------------------------------------------
# AABB tree (core/aabbtree.cpp): median-split BVH over triangles
# ---------------------------------------------------------------------------


class AABBTree:
    """Static bounding-volume hierarchy for closest-point and ray queries
    (reference core/aabbtree.cpp). Median split over triangle centroids;
    flat-array nodes; iterative best-first traversal."""

    LEAF_SIZE = 8

    def __init__(self, mesh: TriMesh):
        self.tri = mesh.triangles().astype(np.float64)
        n = len(self.tri)
        cent = self.tri.mean(1)
        tmin = self.tri.min(1)
        tmax = self.tri.max(1)
        order = np.arange(n)
        nodes_min, nodes_max, nodes_l, nodes_r, nodes_s, nodes_c = [], [], [], [], [], []

        def build(idx):
            ni = len(nodes_min)
            nodes_min.append(tmin[idx].min(0))
            nodes_max.append(tmax[idx].max(0))
            nodes_l.append(-1)
            nodes_r.append(-1)
            nodes_s.append(-1)
            nodes_c.append(0)
            if len(idx) <= self.LEAF_SIZE:
                nodes_s[ni] = len(self._leaf_order)
                nodes_c[ni] = len(idx)
                self._leaf_order.extend(idx.tolist())
                return ni
            axis = int(np.argmax(nodes_max[ni] - nodes_min[ni]))
            half = len(idx) // 2
            part = idx[np.argpartition(cent[idx, axis], half)]
            nodes_l[ni] = build(part[:half])
            nodes_r[ni] = build(part[half:])
            return ni

        self._leaf_order: list = []
        import sys
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000))
        try:
            build(order)
        finally:
            sys.setrecursionlimit(old_limit)
        self.nmin = np.asarray(nodes_min)
        self.nmax = np.asarray(nodes_max)
        self.left = np.asarray(nodes_l, dtype=np.int64)
        self.right = np.asarray(nodes_r, dtype=np.int64)
        self.start = np.asarray(nodes_s, dtype=np.int64)
        self.count = np.asarray(nodes_c, dtype=np.int64)
        self.leaf_tris = self.tri[np.asarray(self._leaf_order, dtype=np.int64)]
        self.leaf_ids = np.asarray(self._leaf_order, dtype=np.int64)

    def _box_dist2(self, p, ni):
        d = np.maximum(np.maximum(self.nmin[ni] - p, 0.0), p - self.nmax[ni])
        return float(d @ d)

    def closest_point(self, points: np.ndarray):
        """(Q, 3) query -> (dist (Q,), closest (Q, 3), tri_id (Q,))."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        q = len(points)
        best_d = np.full(q, np.inf)
        best_p = np.zeros((q, 3))
        best_t = np.zeros(q, dtype=np.int64)
        for qi in range(q):
            p = points[qi]
            stack = [0]
            while stack:
                ni = stack.pop()
                if self._box_dist2(p, ni) >= best_d[qi]:
                    continue
                if self.count[ni] > 0:  # leaf
                    s, c = self.start[ni], self.count[ni]
                    tri = self.leaf_tris[s:s + c]
                    cp = _closest_on_triangles(np.broadcast_to(p, (c, 3)), tri)
                    d2 = ((cp - p) ** 2).sum(1)
                    k = int(np.argmin(d2))
                    if d2[k] < best_d[qi]:
                        best_d[qi] = d2[k]
                        best_p[qi] = cp[k]
                        best_t[qi] = self.leaf_ids[s + k]
                else:
                    l, r = self.left[ni], self.right[ni]
                    dl, dr = self._box_dist2(p, l), self._box_dist2(p, r)
                    # push farther first so nearer is processed next
                    stack.extend([l, r] if dl >= dr else [r, l])
        return np.sqrt(best_d), best_p, best_t


def raycast(mesh: TriMesh, origins: np.ndarray, dirs: np.ndarray,
            eps: float = 1e-9):
    """Batch Möller–Trumbore ray/triangle intersection, brute force over
    triangles (vectorized; the asset meshes are small). Returns (t (Q,),
    tri_id (Q,)) with t=inf for misses. Replaces the AABB-tree trace used by
    the reference's SDF builder (core/aabbtree.cpp TraceRay)."""
    origins = np.atleast_2d(np.asarray(origins, dtype=np.float64))
    dirs = np.atleast_2d(np.asarray(dirs, dtype=np.float64))
    tri = mesh.triangles().astype(np.float64)
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    t_best = np.full(len(origins), np.inf)
    id_best = np.full(len(origins), -1, dtype=np.int64)
    for qi in range(len(origins)):
        o, d = origins[qi], dirs[qi]
        pvec = np.cross(d, e2)
        det = np.einsum("ij,ij->i", e1, pvec)
        ok = np.abs(det) > eps
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tvec = o - v0
        u = np.einsum("ij,ij->i", tvec, pvec) * inv
        qvec = np.cross(tvec, e1)
        v = (qvec @ d) * inv
        t = np.einsum("ij,ij->i", e2, qvec) * inv
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps)
        if hit.any():
            k = int(np.argmin(np.where(hit, t, np.inf)))
            t_best[qi] = t[k]
            id_best[qi] = k
    return t_best, id_best


# ---------------------------------------------------------------------------
# voxelization + SDF (core/voxelize.cpp, core/sdf.cpp)
# ---------------------------------------------------------------------------


class VoxelGrid(NamedTuple):
    occupancy: np.ndarray  # (nx, ny, nz) bool
    origin: np.ndarray  # (3,) world position of cell (0,0,0) center
    dx: float  # cell edge length


def voxelize(mesh: TriMesh, dx: float | None = None, dims: tuple | None = None,
             margin: int = 0) -> VoxelGrid:
    """Interior voxelization by x-ray parity counting (core/voxelize.cpp):
    a cell is inside iff a +x ray from its center crosses the surface an odd
    number of times. Column origins are jittered half a ULP off exact edge
    alignment to dodge shared-edge double counts."""
    lo, hi = mesh.bounds
    ext = hi - lo
    if dx is None:
        assert dims is not None, "need dx or dims"
        dx = float(ext.max()) / max(dims)
    nx, ny, nz = (np.maximum(np.ceil(ext / dx).astype(int), 1) + 2 * margin)
    origin = lo - (margin - 0.5) * dx
    cy = origin[1] + np.arange(ny) * dx + dx * 1.17e-4  # jitter off edges
    cz = origin[2] + np.arange(nz) * dx + dx * 0.93e-4
    cx = origin[0] + np.arange(nx) * dx

    tri = mesh.triangles().astype(np.float64)
    crossings = np.zeros((nx, ny, nz), dtype=np.int32)
    yy, zz = np.meshgrid(cy, cz, indexing="ij")  # (ny, nz)
    cols = np.stack([yy.ravel(), zz.ravel()], 1)  # (ny*nz, 2)
    for t in tri:
        # 2D point-in-triangle in the (y, z) plane via signed areas
        a, b, c = t[0, 1:], t[1, 1:], t[2, 1:]
        ymin, zmin = np.minimum(np.minimum(a, b), c)
        ymax, zmax = np.maximum(np.maximum(a, b), c)
        jm = (cols[:, 0] >= ymin) & (cols[:, 0] <= ymax) \
            & (cols[:, 1] >= zmin) & (cols[:, 1] <= zmax)
        if not jm.any():
            continue
        pc = cols[jm]
        d0 = (b[0] - a[0]) * (pc[:, 1] - a[1]) - (b[1] - a[1]) * (pc[:, 0] - a[0])
        d1 = (c[0] - b[0]) * (pc[:, 1] - b[1]) - (c[1] - b[1]) * (pc[:, 0] - b[0])
        d2 = (a[0] - c[0]) * (pc[:, 1] - c[1]) - (a[1] - c[1]) * (pc[:, 0] - c[0])
        inside = ((d0 >= 0) & (d1 >= 0) & (d2 >= 0)) | ((d0 <= 0) & (d1 <= 0) & (d2 <= 0))
        area2 = d0 + d1 + d2
        degenerate = np.abs(area2) < 1e-18
        inside &= ~degenerate
        if not inside.any():
            continue
        # barycentric interpolation of the crossing x
        w0 = d1[inside] / area2[inside]
        w1 = d2[inside] / area2[inside]
        w2 = d0[inside] / area2[inside]
        x_hit = w0 * t[0, 0] + w1 * t[1, 0] + w2 * t[2, 0]
        col_idx = np.nonzero(jm)[0][inside]
        # cells whose center is left of the hit gain one crossing on the +x ray
        hit_gt_center = cx[:, None] < x_hit[None, :]  # (nx, n_hits)
        np.add.at(crossings.reshape(nx, -1), (slice(None), col_idx),
                  hit_gt_center.astype(np.int32))
    return VoxelGrid(occupancy=(crossings % 2 == 1), origin=origin.astype(np.float64),
                     dx=float(dx))


class SDFGrid(NamedTuple):
    values: np.ndarray  # (nx, ny, nz) f32, negative inside
    origin: np.ndarray  # (3,)
    dx: float

    def sample(self, points: np.ndarray) -> np.ndarray:
        """Trilinear SDF lookup at world points (Q, 3)."""
        p = (np.atleast_2d(points) - self.origin) / self.dx
        shape = np.asarray(self.values.shape)
        i0 = np.clip(np.floor(p).astype(int), 0, shape - 2)
        f = np.clip(p - i0, 0.0, 1.0)
        v = self.values
        out = np.zeros(len(p))
        for corner in range(8):
            ox, oy, oz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            w = (f[:, 0] if ox else 1 - f[:, 0]) * (f[:, 1] if oy else 1 - f[:, 1]) \
                * (f[:, 2] if oz else 1 - f[:, 2])
            out += w * v[i0[:, 0] + ox, i0[:, 1] + oy, i0[:, 2] + oz]
        return out


def signed_distance_grid(mesh: TriMesh, dims: int = 32, margin: int = 2) -> SDFGrid:
    """Dense SDF: unsigned distance to the surface via the AABB tree, sign
    from parity voxelization (core/sdf.cpp MakeSDF recipe)."""
    vox = voxelize(mesh, dims=(dims, dims, dims), margin=margin)
    nx, ny, nz = vox.occupancy.shape
    gx, gy, gz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    pts = vox.origin + np.stack([gx, gy, gz], -1).reshape(-1, 3) * vox.dx
    tree = AABBTree(mesh)
    dist, _, _ = tree.closest_point(pts)
    sign = np.where(vox.occupancy.ravel(), -1.0, 1.0)
    return SDFGrid(values=(dist * sign).reshape(nx, ny, nz).astype(np.float32),
                   origin=vox.origin, dx=vox.dx)


# ---------------------------------------------------------------------------
# mesh -> particles -> soft asset (flexExtSoft.cpp SampleMesh +
# NvFlexExtCreateSoftFromMesh)
# ---------------------------------------------------------------------------


def sample_mesh(mesh: TriMesh, radius: float, surface_samples: int = 0,
                rng: np.random.RandomState | None = None) -> np.ndarray:
    """Particle positions covering the mesh volume: interior voxel centers at
    spacing=radius, optionally augmented with area-weighted surface samples
    deduplicated against the grid (flexExtSoft.cpp:394 SampleMesh)."""
    vox = voxelize(mesh, dx=radius)
    ii = np.argwhere(vox.occupancy)
    pts = vox.origin + ii * vox.dx
    if surface_samples and rng is not None:
        tri = mesh.triangles().astype(np.float64)
        area = 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
        fsel = rng.choice(len(tri), size=surface_samples, p=area / area.sum())
        r1 = np.sqrt(rng.rand(surface_samples, 1))
        r2 = rng.rand(surface_samples, 1)
        t = tri[fsel]
        surf = (1 - r1) * t[:, 0] + r1 * (1 - r2) * t[:, 1] + r1 * r2 * t[:, 2]
        accepted: list = []
        for s in surf:  # dedupe against interior + accepted surface
            pool = pts if not accepted else np.concatenate([pts, np.asarray(accepted)], 0)
            d = np.linalg.norm(pool - s, axis=1).min() if len(pool) else np.inf
            if d >= radius * 0.5:
                accepted.append(s)
        if accepted:
            pts = np.concatenate([pts, np.asarray(accepted)], 0)
    return pts.astype(np.float32)


def _pairs_within(pts: np.ndarray, r: float):
    """All unordered point pairs closer than r, via a uniform cell hash
    (linear in output size — the dense N^2 matrix would need ~3 GB at the
    16k-particle granular cap). Returns (idx (S, 2) i32, dist (S,) f32)."""
    cell = np.floor(pts / r).astype(np.int64)
    ii, jj = [], []
    order: dict = {}
    for i, c in enumerate(map(tuple, cell)):
        order.setdefault(c, []).append(i)
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]
    for c, members in order.items():
        cand: list = []
        for off in offsets:
            cand.extend(order.get((c[0] + off[0], c[1] + off[1], c[2] + off[2]), []))
        cand = np.asarray(cand)
        m = np.asarray(members)
        d = np.linalg.norm(pts[m][:, None] - pts[cand][None, :], axis=-1)
        a, b = np.nonzero(d < r)
        gi, gj = m[a], cand[b]
        keep = gi < gj  # each unordered pair once
        ii.append(gi[keep])
        jj.append(gj[keep])
    gi = np.concatenate(ii) if ii else np.zeros(0, np.int64)
    gj = np.concatenate(jj) if jj else np.zeros(0, np.int64)
    # a cross-cell pair is seen from both cells: keep each once
    idx = np.unique(np.stack([gi, gj], 1), axis=0).astype(np.int32)
    dist = np.linalg.norm(pts[idx[:, 0]] - pts[idx[:, 1]], axis=-1).astype(np.float32)
    return idx, dist


class SoftAsset(NamedTuple):
    """Mesh-derived soft-body recipe, ready for make_clusters/make_springs."""
    points: np.ndarray  # (N, 3) f32
    clusters: list  # list of member index arrays
    cluster_stiffness: float
    spring_idx: np.ndarray  # (S, 2) i32 links within link_radius
    spring_rest: np.ndarray  # (S,) f32
    spring_stiffness: float
    global_stiffness: float  # >0 adds the all-particle global cluster


def soft_from_mesh(mesh: TriMesh, particle_radius: float,
                   cluster_spacing: float = 2.0, cluster_stiffness: float = 0.55,
                   link_radius: float = 0.0, link_stiffness: float = 1.0,
                   global_stiffness: float = 0.0) -> SoftAsset:
    """`NvFlexExtCreateSoftFromMesh` equivalent (flexExtSoft.cpp:510-640):
    recenter -> sample particles -> greedy-ball-cover shape-matching clusters
    at cluster_spacing*radius -> link springs between particle pairs closer
    than link_radius -> optional global cluster (the rope material-stiffness
    knob, flexExtSoft.cpp:592-616; spacings are multiples of the particle
    radius as in by_softrope.h:126-164)."""
    from adaptigraph_torch.scenes.build import greedy_ball_cover

    lo, hi = mesh.bounds
    mesh = mesh.translated(-(lo + hi) / 2)  # recenter (flexExtSoft.cpp:512-525)
    pts = sample_mesh(mesh, particle_radius)
    clusters = greedy_ball_cover(pts, cluster_spacing * particle_radius)

    if link_radius > 0:
        idx, rest = _pairs_within(pts, link_radius * particle_radius)
    else:
        idx = np.zeros((0, 2), dtype=np.int32)
        rest = np.zeros((0,), dtype=np.float32)

    return SoftAsset(points=pts, clusters=clusters,
                     cluster_stiffness=float(cluster_stiffness),
                     spring_idx=idx, spring_rest=rest,
                     spring_stiffness=float(link_stiffness),
                     global_stiffness=float(global_stiffness))
