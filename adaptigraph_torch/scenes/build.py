"""Scene builders: sampled parameters -> engine state/spec. The rope,
granular and cloth builders of adaptigraph_tpu/scenes/build.py.

Construction is host-side numpy, run once per episode; the result goes to
`device` once at the end. The same RandomState gives the same arrays as
the JAX builder.

  * rope: a capsule-volume particle lattice; overlapping greedy ball-cover
    shape-matching clusters at cluster_spacing * radius; no springs; a
    weak global cluster (folded into the cluster matmul); particles below
    y = pin_below_y pinned.
  * granular: a grid of rigid granules, each a voxel-sampled random convex
    blob in a collision group of its own and one shape-matching cluster
    (disjoint contiguous index ranges, so the segment cluster pass); no
    self-collision, no global cluster. A capacity cap drops the remaining
    granules and stamps the count as `truncated_granules`.
  * cloth: a dimx x dimz particle grid in the xz plane with stretch, bend
    and shear distance springs (attach_incidence turns them into six
    static-offset families); every particle self-collides; no clusters.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from adaptigraph_torch.engine.state import (
    SHAPE_PLANE, SceneSpec, SceneState, ShapeSet, build_cluster_incidence,
    build_cluster_matmul, build_cluster_segments, build_spring_incidence,
    empty_clusters, empty_springs, fold_global_cluster, make_clusters,
    make_params, make_particles, make_shapes, make_springs,
    springs_to_offset_families, trim_cluster_matmul)
from adaptigraph_torch.scenes.mesh import import_obj, sample_mesh
from adaptigraph_torch.scenes.samplers import sample_scene
from adaptigraph_torch.utils.device import resolve_device


class Caps(NamedTuple):
    n: int  # particles
    s: int  # springs
    c: int  # clusters
    k: int  # members per cluster
    m: int  # kinematic shapes


# particle-capacity buckets for per-scene right-sizing (bucket_caps):
# granular scenes span ~2k..33k active particles
N_BUCKETS = (4096, 8192, 16384, 32768)


def bucket_caps(probe_n_active: int, probe_clusters: int, probe_members: int,
                base: Caps) -> Caps:
    """Smallest capacity set covering a probed scene: n from N_BUCKETS,
    cluster count and width rounded up to 128. Falls back to `base` when
    the probe exceeds every bucket."""
    n = next((b for b in N_BUCKETS if b >= probe_n_active), base.n)
    rnd = lambda v: max(128, -(-int(v) // 128) * 128)  # noqa: E731
    return base._replace(n=min(n, base.n),
                         c=min(rnd(probe_clusters), base.c),
                         k=min(rnd(probe_members), base.k))


MATERIAL_CAPS = {
    "rope": Caps(n=3072, s=0, c=384, k=640, m=8),
    # k=1024: a granule blob voxel-samples at most a 10^3 grid at the
    # sampler's largest granular_scale
    "granular": Caps(n=32768, s=0, c=768, k=1024, m=8),
    "cloth": Caps(n=4900, s=30720, c=0, k=0, m=8),
}


class SceneBuild(NamedTuple):
    state: SceneState
    spec: SceneSpec
    scene: dict  # sampled scene parameters
    props: dict  # property_params (physics labels)
    n_active: int
    substeps: int
    iterations: int


def greedy_ball_cover(points: np.ndarray, radius: float):
    """Greedy set-cover clustering: repeatedly seed from the highest-index
    unused point and claim everything within `radius` (used points
    included, so clusters may overlap). Returns a list of index arrays."""
    n = len(points)
    used = np.zeros(n, dtype=bool)
    clusters = []
    for seed in range(n - 1, -1, -1):
        if used[seed]:
            continue
        d = np.linalg.norm(points - points[seed], axis=1)
        members = np.nonzero(d < radius)[0]
        used[members] = True
        clusters.append(members)
    return clusters


def _cylinder_lattice(length: float, rad: float, spacing: float):
    """Particle lattice filling a capsule-ish cylinder along +x, centered."""
    nx = max(int(length / spacing), 1)
    xs = (np.arange(nx) - (nx - 1) / 2) * spacing
    r_steps = np.arange(-int(rad / spacing), int(rad / spacing) + 1) * spacing
    yy, zz = np.meshgrid(r_steps, r_steps, indexing="ij")
    disk = np.stack([yy.ravel(), zz.ravel()], 1)
    disk = disk[np.linalg.norm(disk, axis=1) <= rad]
    pts = np.concatenate(
        [np.concatenate([np.full((len(disk), 1), x), disk], axis=1) for x in xs],
        axis=0)
    return pts.astype(np.float32)


def _rot_z(deg):
    t = np.deg2rad(deg)
    return np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0],
                     [0, 0, 1]], dtype=np.float32)


def _rot_y(deg):
    t = np.deg2rad(deg)
    return np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                     [-np.sin(t), 0, np.cos(t)]], dtype=np.float32)


def build_rope(scene: dict, rng: np.random.RandomState, caps: Caps, device):
    radius = scene["radius"]
    # world dimensions of the reference's rope.obj scaled by
    # [length, 3, 3] * 50 * radius
    length_world = scene["length"] * 50 * radius
    rope_radius_world = 0.0329 * (3.0 * 50 * radius) / 2
    if scene.get("mesh_path"):
        # the OBJ-driven rope: the mesh normalized to unit extent, scaled
        # to the world dimensions, centred, then volume-sampled at the
        # particle radius
        m = import_obj(scene["mesh_path"]).normalized()
        lo, hi = m.bounds
        ext = hi - lo
        scale = np.array([length_world / max(ext[0], 1e-6),
                          2 * rope_radius_world / max(ext[1], 1e-6),
                          2 * rope_radius_world / max(ext[2], 1e-6)],
                         np.float32)
        m = m.scaled(scale)
        lo, hi = m.bounds
        m = m.translated(-(lo + hi) / 2)
        pts = sample_mesh(m, radius)
    else:
        pts = _cylinder_lattice(length_world, rope_radius_world,
                                spacing=radius)
    if len(pts) > caps.n:
        # cap overflow drops tail x-slices (a slightly shorter rope),
        # stamped into property_params by build_scene
        scene["truncated_particles"] = int(len(pts) - caps.n)
        pts = pts[: caps.n]
    rot = _rot_y(scene["y_rotation"]) @ _rot_z(scene["z_rotation"])
    pts = pts @ rot.T + scene["translation"].astype(np.float32)

    spacing = scene["cluster_spacing"] * radius
    members = greedy_ball_cover(pts, spacing)
    clusters = make_clusters(members, pts, scene["cluster_stiffness"],
                             c_max=caps.c, k_max=caps.k, device=device)

    inv_mass = np.ones(len(pts), dtype=np.float32)
    inv_mass[pts[:, 1] < scene["pin_below_y"]] = 0.0

    particles = make_particles(pts, inv_mass=inv_mass, group=0,
                               self_collide=True, n_max=caps.n, device=device)
    rest_pos = np.zeros((caps.n, 3), dtype=np.float32)
    rest_pos[: len(pts)] = pts

    eff_radius = radius * scene["radius_scale"]
    params = make_params(
        device,
        radius=eff_radius,
        solid_rest_distance=eff_radius,
        collision_distance=scene["collision_distance"],
        dynamic_friction=scene["dynamic_friction"],
        particle_friction=scene["particle_friction"],
        relaxation_factor=scene["relaxation_factor"],
        collide_filter_dist=eff_radius,
    )
    global_rest = rest_pos - pts.mean(0, keepdims=True)
    global_rest[len(pts):] = 0.0
    spec = SceneSpec(
        springs=empty_springs(caps.s, device=device),
        clusters=clusters,
        global_stiffness=torch.tensor(float(np.float32(scene["global_stiffness"])),
                                      dtype=torch.float32, device=device),
        global_rest=torch.as_tensor(global_rest, device=device),
        rest_pos=torch.as_tensor(rest_pos, device=device),
        params=params,
    )
    return particles, spec, len(pts)


def _random_convex_blob(rng, num_planes, min_dist, max_dist, scale, spacing,
                        jitter):
    """Voxel-sample the interior of a random convex polytope. Returns
    (n, 3) points with extents ~ scale."""
    dirs = rng.randn(num_planes, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dists = rng.uniform(min_dist, max_dist, size=num_planes)
    half = scale / 2.0
    axes = np.arange(-half, half + 1e-6, spacing)
    if len(axes) == 0:
        axes = np.array([0.0])
    gx, gy, gz = np.meshgrid(axes, axes, axes, indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1).astype(np.float32)
    # map voxel coords into plane units (polytope inradius >= min_dist)
    plane_scale = dists.mean() / (half + 1e-9)
    inside = np.all(grid * plane_scale @ dirs.T <= dists[None, :], axis=1)
    pts = grid[inside]
    if len(pts) == 0:
        pts = np.zeros((1, 3), dtype=np.float32)
    pts = pts + rng.uniform(-jitter, jitter, size=pts.shape).astype(np.float32)
    return pts.astype(np.float32)


def build_granular(scene: dict, rng: np.random.RandomState, caps: Caps,
                   device):
    radius = scene["radius"]
    spacing = radius * 1.001
    pos_diff = scene["granular_scale"] + scene["granular_dis"]
    origin = scene["origin"]
    all_pts, groups, members = [], [], []
    count, full = 0, False
    for xi in range(scene["num_x"]):
        if full:
            break
        for zi in range(scene["num_z"]):
            npl = rng.randint(scene["num_planes_range"][0],
                              scene["num_planes_range"][1])
            blob = _random_convex_blob(rng, npl, scene["shape_min_dist"],
                                       scene["shape_max_dist"],
                                       scene["granular_scale"], spacing,
                                       scene["jitter"])
            lower = origin + np.array([xi * pos_diff, 0.0, zi * pos_diff])
            blob = blob - blob.min(0) + lower.astype(np.float32)
            if count + len(blob) > caps.n or len(members) >= caps.c:
                # capacity-capped: stamp the granules the grid wanted
                want = scene["num_x"] * scene["num_z"]
                scene["truncated_granules"] = int(want - len(members))
                full = True
                break
            idx0 = sum(len(p) for p in all_pts)
            all_pts.append(blob)
            members.append(np.arange(idx0, idx0 + len(blob)))
            groups.append(np.full(len(blob), len(members) - 1, dtype=np.int32))
            count += len(blob)
    pts = np.concatenate(all_pts, 0)
    group = np.concatenate(groups, 0)
    members = members[: caps.c]
    clusters = make_clusters(list(members), pts, scene["rigid_stiffness"],
                             c_max=caps.c, k_max=caps.k, device=device)
    inv_mass = np.full(len(pts), 1.0 / scene["granular_mass"], dtype=np.float32)
    particles = make_particles(pts, inv_mass=inv_mass, group=group,
                               self_collide=False, n_max=caps.n, device=device)
    rest_pos = np.zeros((caps.n, 3), dtype=np.float32)
    rest_pos[: len(pts)] = pts
    params = make_params(
        device,
        radius=radius,
        solid_rest_distance=radius,
        collision_distance=scene["collision_distance"],
        shape_collision_margin=scene["shape_collision_margin"],
        dynamic_friction=scene["dynamic_friction"],
        dissipation=scene["dissipation"],
        sleep_threshold=scene["sleep_threshold"],
        relaxation_factor=scene["relaxation_factor"],
        # physical speed clamp: rigid-granule and shape contacts can eject
        # a particle at great speed in a bad substep
        max_speed=25.0,
    )
    spec = SceneSpec(
        springs=empty_springs(caps.s, device=device),
        clusters=clusters,
        global_stiffness=torch.zeros((), dtype=torch.float32, device=device),
        global_rest=torch.zeros((0, 3), dtype=torch.float32, device=device),
        rest_pos=torch.as_tensor(rest_pos, device=device),
        params=params,
    )
    return particles, spec, len(pts)


def build_cloth(scene: dict, rng: np.random.RandomState, caps: Caps, device):
    radius = scene["radius"]
    dimx, dimz = scene["dimx"], scene["dimz"]
    xs, zs = np.meshgrid(np.arange(dimx), np.arange(dimz), indexing="xy")
    # the grid lies in the xz plane
    pts = np.stack([xs.ravel() * radius, np.zeros(dimx * dimz),
                    zs.ravel() * radius], 1)
    pts = (pts + scene["origin"]).astype(np.float32)

    def gid(x, z):
        return z * dimx + x

    sidx, srest, sstiff = [], [], []

    def add(a, b, stiff):
        sidx.append((a, b))
        srest.append(np.linalg.norm(pts[a] - pts[b]))
        sstiff.append(stiff)

    for z in range(dimz):
        for x in range(dimx):
            if x > 0:
                add(gid(x, z), gid(x - 1, z), scene["stretch_stiffness"])
            if x > 1:
                add(gid(x, z), gid(x - 2, z), scene["bend_stiffness"])
            if z > 0 and x < dimx - 1:
                add(gid(x, z), gid(x + 1, z - 1), scene["shear_stiffness"])
            if z > 0 and x > 0:
                add(gid(x, z), gid(x - 1, z - 1), scene["shear_stiffness"])
            if z > 0:
                add(gid(x, z), gid(x, z - 1), scene["stretch_stiffness"])
            if z > 1:
                add(gid(x, z), gid(x, z - 2), scene["bend_stiffness"])
    springs = make_springs(np.array(sidx), np.array(srest), np.array(sstiff),
                           capacity=caps.s, device=device)

    inv_mass = np.full(len(pts), dimx * dimz / scene["cloth_mass"],
                       dtype=np.float32)
    particles = make_particles(pts, inv_mass=inv_mass, group=0,
                               self_collide=True, n_max=caps.n, device=device)
    rest_pos = np.zeros((caps.n, 3), dtype=np.float32)
    rest_pos[: len(pts)] = pts
    eff_radius = radius * scene["radius_scale"]
    params = make_params(
        device,
        radius=eff_radius,
        solid_rest_distance=eff_radius,
        collision_distance=scene["collision_distance"],
        shape_collision_margin=scene["shape_collision_margin"],
        dynamic_friction=scene["dynamic_friction"],
        static_friction=scene["static_friction"],
        particle_friction=scene["particle_friction"],
        damping=scene["damping"],
        sleep_threshold=scene["sleep_threshold"],
        relaxation_factor=scene["relaxation_factor"],
        collide_filter_dist=eff_radius,
    )
    spec = SceneSpec(
        springs=springs,
        clusters=empty_clusters(caps.c, caps.k, device=device),
        global_stiffness=torch.zeros((), dtype=torch.float32, device=device),
        global_rest=torch.zeros((0, 3), dtype=torch.float32, device=device),
        rest_pos=torch.as_tensor(rest_pos, device=device),
        params=params,
    )
    return particles, spec, len(pts)


def attach_incidence(spec: SceneSpec, n: int) -> SceneSpec:
    """The topology tables of the solver's gather passes, in the JAX
    package's order:
    1. springs whose index offsets form static families (cloth grid,
       chains) become OffsetSprings;
    2. the springs left over get a per-particle incidence table;
    3. clusters get the per-particle incidence table; the contiguous-segment
       form when every cluster is a disjoint contiguous range (granular);
       else the membership-matrix pass when the matrix fits (C * N <= 8M;
       the rope's overlapping ball cover).
    Topology only: the constraints are unchanged."""
    device = spec.rest_pos.device
    if spec.offset_springs is None and spec.springs.idx.shape[0] > 0:
        sv = spec.springs.valid.cpu().numpy()
        if sv.any():
            idx = spec.springs.idx.cpu().numpy()[sv]
            rest = spec.springs.rest.cpu().numpy()[sv]
            stiff = spec.springs.stiffness.cpu().numpy()[sv]
            fams, leftover = springs_to_offset_families(idx, rest, stiff, n,
                                                        device=device)
            if fams is not None:
                spec = spec._replace(offset_springs=fams)
                if leftover.any():
                    spec = spec._replace(springs=make_springs(
                        idx[leftover], rest[leftover], stiff[leftover],
                        device=device))
                else:
                    spec = spec._replace(springs=empty_springs(0, device))
    if spec.spring_inc is None and spec.springs.idx.shape[0] > 0:
        spec = spec._replace(
            spring_inc=build_spring_incidence(spec.springs, n))
    c, k = spec.clusters.member.shape
    if c == 0 or k == 0:
        return spec
    if spec.cluster_inc is None:
        spec = spec._replace(cluster_inc=build_cluster_incidence(spec.clusters, n))
    if spec.cluster_seg is None:
        seg = build_cluster_segments(spec.clusters, spec.rest_pos, n)
        if seg is not None:
            spec = spec._replace(cluster_seg=seg)
    if (spec.cluster_mm is None and spec.cluster_seg is None
            and c * n <= 8_000_000):
        mm = build_cluster_matmul(spec.clusters, spec.rest_pos, n)
        if mm is not None:
            spec = spec._replace(cluster_mm=mm)
    return spec


_BUILDERS = {"rope": build_rope, "granular": build_granular,
             "cloth": build_cloth}


def build_scene(material: str, rng: np.random.RandomState,
                shapes: ShapeSet | None = None, caps: Caps | None = None,
                scene_overrides: dict | None = None,
                device=None) -> SceneBuild:
    """Sample and build a full scene on `device` (CUDA unless given).
    `shapes` supplies the kinematic set (made on the same device); if None,
    a lone floor plane is used. `scene_overrides` patches sampled scene
    parameters."""
    device = resolve_device(device)
    scene, props = sample_scene(material, rng)
    caps = caps or MATERIAL_CAPS[material]
    if scene_overrides:
        scene.update(scene_overrides)
    particles, spec, n_active = _BUILDERS[material](scene, rng, caps, device)
    spec = attach_incidence(spec, caps.n)
    spec = fold_global_cluster(spec, particles)
    # drop the all-zero cap-padding rows from the membership matmuls; must
    # follow the fold, which claims the first free row
    spec = trim_cluster_matmul(spec)
    for key in ("truncated_particles", "truncated_granules"):
        if key in scene:
            props[key] = scene[key]
    if shapes is None:
        shapes = make_shapes([SHAPE_PLANE], [[0, 0, 0]], [[0, 0, 0]],
                             [[0, 0, 0, 1]], m_max=caps.m, device=device)
    state = SceneState(
        particles=particles,
        shapes=shapes,
        cluster_rot=torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=device).repeat(
            caps.c, 1),
        global_rot=torch.tensor([0.0, 0.0, 0.0, 1.0], device=device),
        contact_overflow=torch.zeros((), dtype=torch.int32, device=device),
    )
    return SceneBuild(state=state, spec=spec, scene=scene, props=props,
                      n_active=n_active, substeps=scene["substeps"],
                      iterations=scene["iterations"])
