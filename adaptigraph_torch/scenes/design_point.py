"""The design points the port is driven at, built through the port.

The rope design point of bench.py (bench_pbd). bench.py's rope: length 6 along z, a floor and a box pusher, RandomState(0),
a 5,120-particle cap, 2 substeps x 4 iterations, the pusher sweeping
through the rope's midline. bench.py zeroes the scene translation, which
puts every particle below the pin rule's y = 0.4 and so pins the whole
rope; `lifted=True` raises it to the sampler's own height (y = 0.5), where
the rope is free, falls onto the floor and is pushed.

The granular design point: RandomState(0), 26,982 particles in 110
granules, at the capacities SimEnv picks (sim/env.py's bucketing: the
32,768 bucket), with SimEnv's granular shape set without the robot and
its tool speed. Its dense band: RandomState(3) at a 2,048 cap (1,866
particles in 8 granules), the scene the JAX package's granular
friction-band test runs.

The cloth design point: the cloth sampler's draw for RandomState(0), a
70 x 70 = 4,900-particle sheet at the material's capacities
(Caps(n=4900, s=30720, c=0, k=0, m=8)), 4 substeps x 50 iterations. Its
28,702 springs become six offset families (offsets 1, 2, 69, 70, 71 and
140) with nothing left over. The sheet starts CLOTH_GAP above the floor plane
(an origin override of y), so it lands within the first frames (a 0.095
fall to the 0.005 contact offset: about 9 frames). The box is the rope
design point's pusher (half extents 0.05, 0.4, 0.8) at y = 0.35, centred
on the sheet in z, its face 0.05 before the sheet's edge along x at frame
0 and moving +x at BOARD_SPEED (cloth_sweep), so it meets the landed
sheet's edge at about frame 15. Shapes run unfused, as SimEnv runs them by
default, so K4 is not on this path. At 4,900 particles auto_contact_mode
picks `block`: tile_j 128, 39 row tiles, lists of up to 39 blocks (maxb
39); every particle self-collides, so the rest filter is on. A frame
launches K1 200 times and K2 once.
"""

from __future__ import annotations

import numpy as np
import torch

from adaptigraph_torch.engine.state import SHAPE_BOX, SHAPE_PLANE, make_shapes
from adaptigraph_torch.scenes.build import (
    MATERIAL_CAPS, Caps, SceneBuild, bucket_caps, build_scene)
from adaptigraph_torch.utils.device import resolve_device

N_CAP = 5120
GRANULAR_SEED, GRANULAR_DENSE_SEED = 0, 3
GRANULAR_DENSE_CAPS = Caps(n=2048, s=0, c=64, k=1024, m=8)
# SimEnv's workspace table (half extents 3.5 x 0.5 x 4.5, centred at the
# origin): its top is at y = 0.5
TABLE_TOP = 0.5
# the granular sampler puts the pile's bottom at y = 1.0; the design points
# put it PILE_GAP above the table top, so it lands within the first frames
# (a 0.07 fall to the 0.03 contact offset: about 7 frames)
PILE_GAP = 0.1
BOARD_HALF = (0.5, 0.3, 0.04)  # SimEnv's granular tool: a flat board
# SimEnv's tool speed for granular pushes, a frame: 1 / robot_speed_inv
# (adaptigraph_tpu/configs/data_gen/granular.yaml, sim/env.py:70), 0.2 m/s at 60 frames/s
BOARD_SPEED = 1.0 / 300
BOARD_GAP = 0.05  # the board's face before the pile's near face at frame 0
PUSHER_HALF = (0.05, 0.4, 0.8)  # the rope and cloth design points' box
CLOTH_GAP = 0.1  # the cloth sheet's height above the floor at frame 0
CLOTH_PUSHER_Y = 0.35


def rope_design_point(device=None, lifted: bool = True) -> SceneBuild:
    device = resolve_device(device)
    caps = Caps(n=N_CAP, s=0, c=1024, k=640, m=2)
    shapes = make_shapes([SHAPE_PLANE, SHAPE_BOX],
                         [[0, 0, 0], list(PUSHER_HALF)],
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


def granular_shapes(device=None, m_max: int = 8):
    """SimEnv's granular shape set without the robot (sim/env.py
    _build_shapes): the floor plane, the workspace table box, the robot's
    side-table box and the board pusher, parked far above. Made on
    resolve_device(device): CUDA unless a device is given."""
    device = resolve_device(device)
    rtw = 126.0 / 200
    return make_shapes(
        [SHAPE_PLANE, SHAPE_BOX, SHAPE_BOX, SHAPE_BOX],
        [[0, 0, 0], [3.5, TABLE_TOP, 4.5], [rtw, 0.5 + 0.3, rtw],
         list(BOARD_HALF)],
        [[0, 0, 0], [0, 0, 0], [-3.5 - rtw, 0, 0], [0, 20.0, 0]],
        [[0, 0, 0, 1]] * 4, m_max=m_max, device=device)


def granular_scene(seed: int = GRANULAR_SEED, caps: Caps | None = None,
                   device=None) -> SceneBuild:
    """The granular scene of the sampler's draw for `seed`, translated (only
    translated: counts and widths stay as built) so that its bottom lies
    PILE_GAP above the table. caps None: SimEnv's bucketing, a probe build
    at the material's caps, then the smallest bucket that fits. The
    defaults give the 27k design point (26,982 particles, Caps(n=32768,
    s=0, c=128, k=384, m=8)): block contacts at tile_j 256, rest_filter
    False."""
    device = resolve_device(device)
    origin = {"origin": np.array([-1.0, TABLE_TOP + PILE_GAP, -1.0])}
    if caps is None:
        base = MATERIAL_CAPS["granular"]
        probe = build_scene("granular", np.random.RandomState(seed),
                            shapes=granular_shapes("cpu", base.m), caps=base,
                            device="cpu", scene_overrides=origin)
        cl = probe.spec.clusters
        caps = bucket_caps(probe.n_active, int(cl.valid.sum()),
                           int(cl.member_valid.sum(1).max()), base)
    return build_scene("granular", np.random.RandomState(seed),
                       shapes=granular_shapes(device, max(caps.m, 4)),
                       caps=caps, device=device, scene_overrides=origin)


def granular_dense_point(device=None) -> SceneBuild:
    """The granular dense band (1,866 particles at a 2,048 cap): the auto
    contact mode takes the dense sweep."""
    return granular_scene(GRANULAR_DENSE_SEED, GRANULAR_DENSE_CAPS, device)


def board_sweep(b: SceneBuild, t: int):
    """The board's trajectory over t frames: upright, its face across +z,
    its bottom 0.01 above the table, centred on the pile in x, starting
    BOARD_GAP before the pile's near face and moving at SimEnv's tool speed
    (BOARD_SPEED a frame) along +z, so it comes within the 0.03 contact
    distance of the pile's near face at about frame 6 and is 0.1 past it at
    frame 36. Returns numpy (pos (t, M, 3), quat (t, M, 4))."""
    st = b.state
    pts = st.particles.pos[: b.n_active].cpu().numpy()
    slot = 3
    pos_traj = np.tile(st.shapes.pos.cpu().numpy()[None], (t, 1, 1))
    pos_traj[:, slot, 0] = 0.5 * (pts[:, 0].min() + pts[:, 0].max())
    pos_traj[:, slot, 1] = TABLE_TOP + BOARD_HALF[1] + 0.01
    z0 = pts[:, 2].min() - BOARD_HALF[2] - BOARD_GAP
    pos_traj[:, slot, 2] = z0 + BOARD_SPEED * np.arange(t, dtype=np.float32)
    quat_traj = np.tile(st.shapes.quat.cpu().numpy()[None], (t, 1, 1))
    return pos_traj.astype(np.float32), quat_traj.astype(np.float32)


def cloth_design_point(device=None) -> SceneBuild:
    """The cloth design point (module docstring), with the box at its
    first pose of cloth_sweep (no jump at frame 0)."""
    device = resolve_device(device)
    caps = MATERIAL_CAPS["cloth"]
    shapes = make_shapes([SHAPE_PLANE, SHAPE_BOX],
                         [[0, 0, 0], list(PUSHER_HALF)],
                         [[0, 0, 0], [0, 20.0, 0]],
                         [[0, 0, 0, 1], [0, 0, 0, 1]], m_max=caps.m,
                         device=device)
    b = build_scene("cloth", np.random.RandomState(0), shapes=shapes,
                    caps=caps, device=device,
                    scene_overrides={"origin": np.array([-0.5, CLOTH_GAP,
                                                         0.0])})
    start = torch.as_tensor(cloth_sweep(b, 1)[0][0], device=device)
    return b._replace(state=b.state._replace(
        shapes=b.state.shapes._replace(pos=start, prev_pos=start)))


def cloth_sweep(b: SceneBuild, t: int):
    """The box's trajectory over t frames: at y = CLOTH_PUSHER_Y, centred
    on the sheet in z, its face 0.05 before the sheet's edge along x at
    frame 0, moving +x at BOARD_SPEED a frame. Returns numpy
    (pos (t, M, 3), quat (t, M, 4))."""
    st = b.state
    pts = st.particles.pos[: b.n_active].cpu().numpy()
    pos_traj = np.tile(st.shapes.pos.cpu().numpy()[None], (t, 1, 1))
    x0 = pts[:, 0].min() - PUSHER_HALF[0] - 0.05
    pos_traj[:, 1, 0] = x0 + BOARD_SPEED * np.arange(t, dtype=np.float32)
    pos_traj[:, 1, 1] = CLOTH_PUSHER_Y
    pos_traj[:, 1, 2] = 0.5 * (pts[:, 2].min() + pts[:, 2].max())
    quat_traj = np.tile(st.shapes.quat.cpu().numpy()[None], (t, 1, 1))
    return pos_traj.astype(np.float32), quat_traj.astype(np.float32)
