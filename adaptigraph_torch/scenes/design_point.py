"""The rope design point of bench.py (bench_pbd), built through the port.

bench.py's rope: length 6 along z, a floor and a box pusher, RandomState(0),
a 5,120-particle cap, 2 substeps x 4 iterations, the pusher sweeping
through the rope's midline. bench.py zeroes the scene translation, which
puts every particle below the pin rule's y = 0.4 and so pins the whole
rope; `lifted=True` raises it to the sampler's own height (y = 0.5), where
the rope is free, falls onto the floor and is pushed.
"""

from __future__ import annotations

import numpy as np

from adaptigraph_torch.engine.state import SHAPE_BOX, SHAPE_PLANE, make_shapes
from adaptigraph_torch.scenes.build import Caps, SceneBuild, build_scene

N_CAP = 5120


def rope_design_point(device=None, lifted: bool = True) -> SceneBuild:
    caps = Caps(n=N_CAP, s=0, c=1024, k=640, m=2)
    shapes = make_shapes([SHAPE_PLANE, SHAPE_BOX],
                         [[0, 0, 0], [0.05, 0.4, 0.8]],
                         [[0, 0, 0], [0, 0.4, 0]],
                         [[0, 0, 0, 1], [0, 0, 0, 1]], m_max=caps.m,
                         device=device)
    trans = np.array([0.0, 0.5 if lifted else 0.0, 0.0], np.float32)
    return build_scene("rope", np.random.RandomState(0), shapes=shapes,
                       caps=caps, device=device,
                       scene_overrides={"length": 6.0, "translation": trans,
                                        "z_rotation": 0.0, "y_rotation": 90.0})


def pusher_sweep(b: SceneBuild, t: int):
    """bench.py's trajectory: over t frames the pusher crosses the rope's
    midline, from 1.2 before it to 1.2 past it. Returns numpy
    (pos (t, M, 3), quat (t, M, 4))."""
    st = b.state
    center = st.particles.pos[: b.n_active].mean(0).cpu().numpy()
    xs = np.linspace(center[0] - 1.2, center[0] + 1.2, t, dtype=np.float32)
    pos_traj = np.tile(st.shapes.pos.cpu().numpy()[None], (t, 1, 1))
    pos_traj[:, 1, 0] = xs
    pos_traj[:, 1, 1] = 0.35
    pos_traj[:, 1, 2] = center[2]
    quat_traj = np.tile(st.shapes.quat.cpu().numpy()[None], (t, 1, 1))
    return pos_traj, quat_traj
