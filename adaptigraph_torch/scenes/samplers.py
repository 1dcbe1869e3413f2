"""Per-episode physics randomization: the rope, granular and cloth
samplers of adaptigraph_tpu/scenes/samplers.py, host-side numpy. The same
RandomState gives the same dicts as the JAX package's sampler."""

from __future__ import annotations

import numpy as np


def rope_scene(rng: np.random.RandomState):
    radius = 0.03
    length = rng.uniform(2.5, 3.0)
    thickness = 3.0

    # stiffness in [0,1] maps bimodally to (global_stiffness, cluster_spacing)
    stiffness = rng.rand()
    if stiffness < 0.5:
        global_stiffness = stiffness * 1e-4 / 0.5
        cluster_spacing = 2 + 8 * stiffness
    else:
        global_stiffness = (stiffness - 0.5) * 4e-4 + 1e-4
        cluster_spacing = 6 + 4 * (stiffness - 0.5)

    z_rotation = rng.uniform(10.0, 20.0)  # degrees, tilt of the rope axis
    scene = {
        "material": "rope",
        "radius": radius,
        "length": length,
        "thickness": thickness,
        "translation": np.array([0.0, 0.5, 2.0]),
        "y_rotation": 90.0,
        "z_rotation": z_rotation,
        "cluster_spacing": cluster_spacing,
        "cluster_stiffness": 0.55,
        "global_stiffness": global_stiffness,
        "dynamic_friction": 0.1,
        "particle_friction": 0.25,
        "collision_distance": radius * 0.5,
        "relaxation_factor": 1.0,
        # solver schedule: 2 substeps x 4 iterations
        "substeps": 2,
        "iterations": 4,
        "radius_scale": 1.5,
        "pin_below_y": 0.4,
    }
    props = {
        "particle_radius": radius,
        "length": length,
        "thickness": thickness,
        "dynamic_friction": 0.1,
        "cluster_spacing": cluster_spacing,
        "global_stiffness": global_stiffness,
        "stiffness": stiffness,
    }
    return scene, props


def granular_scene(rng: np.random.RandomState):
    radius = 0.03
    granular_scale = rng.uniform(0.1, 0.3)
    area = rng.uniform(1.0, 9.0)
    xz_ratio = rng.uniform(0.8, 1.2)
    x_max = area**0.5 * 0.5 * xz_ratio**0.5
    z_max = area**0.5 * 0.5 * xz_ratio**-0.5
    granular_dis = rng.uniform(0.1 * granular_scale, 0.2 * granular_scale)
    num_x = int((2 * x_max - granular_scale) / (granular_dis + granular_scale) + 1)
    num_z = int((2 * z_max - granular_scale) / (granular_dis + granular_scale) + 1)
    num_granular = num_x * num_z

    scene = {
        "material": "granular",
        "radius": radius,
        "granular_scale": granular_scale,
        "granular_dis": granular_dis,
        "num_x": num_x,
        "num_z": num_z,
        "origin": np.array([-1.0, 1.0, -1.0]),
        "num_planes_range": (6, 10),
        "shape_min_dist": 5.0,
        "shape_max_dist": 10.0,
        "dynamic_friction": 1.0,
        "granular_mass": 0.05,
        "rigid_stiffness": 0.8,
        "collision_distance": 0.03,
        "shape_collision_margin": 0.01,
        # solver schedule: 12 substeps x 6 iterations
        "substeps": 12,
        "iterations": 6,
        "dissipation": 0.001,
        "sleep_threshold": radius * 0.2,
        "relaxation_factor": 1.3,
        "jitter": radius * 0.1,
    }
    props = {
        "particle_radius": radius,
        "granular_scale": granular_scale,
        "num_granular": num_granular,
        "distribution_r": granular_dis,
        "dynamic_friction": 1.0,
        "granular_mass": 0.05,
        "area": area,
        "xz_ratio": xz_ratio,
    }
    return scene, props


def cloth_scene(rng: np.random.RandomState):
    radius = 0.03
    dimx = dimz = 70
    sf = rng.rand()
    stiffness_factor = sf * 1.4 + 0.1
    stretch = float(np.clip(stiffness_factor, 1.0, 1.5))
    bend = stiffness_factor
    shear = stiffness_factor
    dynamic_friction = -sf * 0.9 + 1.0  # inversely coupled to stiffness

    scene = {
        "material": "cloth",
        "radius": radius,
        "dimx": dimx,
        "dimz": dimz,
        "origin": np.array([-0.5, 1.0, 0.0]),
        "stretch_stiffness": stretch,
        "bend_stiffness": bend,
        "shear_stiffness": shear,
        "cloth_mass": 0.1,
        "dynamic_friction": dynamic_friction,
        "static_friction": 0.0,
        "particle_friction": 0.0,
        # solver schedule: 4 substeps x 50 iterations
        "substeps": 4,
        "iterations": 50,
        "radius_scale": 1.8,
        "damping": 1.0,
        "sleep_threshold": 0.02,
        "relaxation_factor": 1.0,
        "collision_distance": 0.005,
        "shape_collision_margin": 0.04,
    }
    props = {
        "particle_radius": radius,
        "stretch_stiffness": stretch,
        "bend_stiffness": bend,
        "shear_stiffness": shear,
        "dynamic_friction": dynamic_friction,
        "sf": sf,
    }
    return scene, props


_SAMPLERS = {"rope": rope_scene, "granular": granular_scene,
             "cloth": cloth_scene}


def sample_scene(material: str, rng: np.random.RandomState):
    try:
        return _SAMPLERS[material](rng)
    except KeyError:
        raise ValueError(f"unknown material {material!r}; choose from "
                         f"{sorted(_SAMPLERS)}") from None
