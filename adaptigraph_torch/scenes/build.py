"""Scene builders: sampled parameters -> engine state/spec. The rope half of
adaptigraph_tpu/scenes/build.py.

Construction is host-side numpy, run once per episode; the result goes to
`device` once at the end. The same RandomState gives the same arrays as
the JAX builder.

  * rope: a capsule-volume particle lattice; overlapping greedy ball-cover
    shape-matching clusters at cluster_spacing * radius; no springs; a
    weak global cluster (folded into the cluster matmul); particles below
    y = pin_below_y pinned.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from adaptigraph_torch.engine.state import (
    SHAPE_PLANE, SceneSpec, SceneState, ShapeSet, build_cluster_incidence,
    build_cluster_matmul, empty_springs, fold_global_cluster, make_clusters,
    make_params, make_particles, make_shapes, trim_cluster_matmul)
from adaptigraph_torch.scenes.samplers import sample_scene
from adaptigraph_torch.utils.device import resolve_device


class Caps(NamedTuple):
    n: int  # particles
    s: int  # springs
    c: int  # clusters
    k: int  # members per cluster
    m: int  # kinematic shapes


MATERIAL_CAPS = {
    "rope": Caps(n=3072, s=0, c=384, k=640, m=8),
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
    if scene.get("mesh_path"):
        raise NotImplementedError(
            "the OBJ-driven rope waits for scenes/mesh.py, ROADMAP Queue 1 "
            "item 7")
    radius = scene["radius"]
    # world dimensions of the reference's rope.obj scaled by
    # [length, 3, 3] * 50 * radius
    length_world = scene["length"] * 50 * radius
    rope_radius_world = 0.0329 * (3.0 * 50 * radius) / 2
    pts = _cylinder_lattice(length_world, rope_radius_world, spacing=radius)
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


def attach_incidence(spec: SceneSpec, n: int) -> SceneSpec:
    """The cluster topology tables: the per-particle incidence table, and
    the membership-matrix pass when the matrix fits (C * N <= 8M). (The JAX
    version first tries the contiguous-segment form, which only disjoint
    contiguous clusters take; the rope's ball cover overlaps, so it never
    does. That form ports with the granular scene.)"""
    c, k = spec.clusters.member.shape
    if c == 0 or k == 0:
        return spec
    if spec.cluster_inc is None:
        spec = spec._replace(cluster_inc=build_cluster_incidence(spec.clusters, n))
    if spec.cluster_mm is None and c * n <= 8_000_000:
        mm = build_cluster_matmul(spec.clusters, spec.rest_pos, n)
        if mm is not None:
            spec = spec._replace(cluster_mm=mm)
    return spec


_BUILDERS = {"rope": build_rope}


def build_scene(material: str, rng: np.random.RandomState,
                shapes: ShapeSet | None = None, caps: Caps | None = None,
                scene_overrides: dict | None = None,
                device=None) -> SceneBuild:
    """Sample and build a full scene on `device` (CUDA unless given).
    `shapes` supplies the kinematic set (made on the same device); if None,
    a lone floor plane is used. `scene_overrides` patches sampled scene
    parameters."""
    device = resolve_device(device)
    scene, props = sample_scene(material, rng)  # raises for unported ones
    caps = caps or MATERIAL_CAPS[material]
    if scene_overrides:
        scene.update(scene_overrides)
    particles, spec, n_active = _BUILDERS[material](scene, rng, caps, device)
    spec = attach_incidence(spec, caps.n)
    spec = fold_global_cluster(spec, particles)
    # drop the all-zero cap-padding rows from the membership matmuls; must
    # follow the fold, which claims the first free row
    spec = trim_cluster_matmul(spec)
    if "truncated_particles" in scene:
        props["truncated_particles"] = scene["truncated_particles"]
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
