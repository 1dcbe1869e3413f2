"""Simulation environment: scripted xArm6 pushes over the particle engine.

The port of adaptigraph_tpu/sim/env.py's SimEnv. reset = build the scene
with the table boxes, the tool and the arm's link hulls, then settle it;
step = decode a 4-dof push action into end-effector waypoints,
interpolate them at robot speed, track them with the arm's IK, then run
the push frame by frame through xpbd_step on the env's device. Captures
land on 40-frame chunk boundaries, gated by the robot-object distance as
the reference's cadence rule is (flex_env.py:369-376), and only the
selected frames are rendered, after the push.

The JAX version runs each group of `chunk_group` chunks as one jitted
program; here a group is a host loop over the frames that keeps what that
program did: an attach-free push packs its contact tables once a group
(solver.pack_tables_for), a grasp push mutates positions and inverse
masses each frame (and xpbd_step packs its tables each frame), positions
are recorded on the device at every chunk boundary, and the explosion
guard (NaN, escape beyond 1e3, a grown contact_overflow) is read once a
group together with the group's recorded positions: the loop's only
host sync. A group's body is `_push_group`, which sim/batch_env.py's
BatchSimEnv runs for each of its envs.

Key differences from the reference, by design (as in the JAX package):
the tool (stick, board or gripper fingers) is driven kinematically along
the commanded trajectory; cloth grasps pin the nearest particles to the
gripper for the grasp; episodes are deterministic in the numpy seed.

Action convention: [x_start, z_start, x_end, z_end] in a frame whose z is
the NEGATED flex z (flex_env.py:426).

`fuse_shapes` (or ADAPTIGRAPH_FUSE_SHAPES) fuses the shape pass over the
first caps.m slots into K1, as the JAX package does: with the arm on the
shape set has 11 slots, so arm links 4-6 are then never collided with.
The port keeps that for parity.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from adaptigraph_torch.engine import (
    SHAPE_BOX, SHAPE_CAPSULE, SHAPE_CONVEX, SHAPE_PLANE, xpbd_step)
from adaptigraph_torch.engine.solver import pack_tables_for
from adaptigraph_torch.engine.state import ShapeSet, make_shapes
from adaptigraph_torch.scenes import build_scene
from adaptigraph_torch.scenes.build import MATERIAL_CAPS, bucket_caps
from adaptigraph_torch.sim import robot
from adaptigraph_torch.sim.cameras import CameraRig
from adaptigraph_torch.sim.render import (
    quantize_frames, render_frame, render_frames_batch)
from adaptigraph_torch.utils import geometry as geo
from adaptigraph_torch.utils.device import resolve_device
from adaptigraph_torch.utils.host_fps import fps_with_idx

CHUNK = 40  # capture granularity in sim steps (contact_interval)
DEFAULT_MAX_CHUNKS = 72  # fixed trajectory capacity: 2880 steps incl. settle

_PARTICLE_COLORS = {
    "rope": np.array([0.5, 0.5, 1.0], np.float32),
    "granular": np.array([237.0, 145.0, 33.0], np.float32) / 255.0,
    "cloth": np.array([0.8, 0.5, 0.7], np.float32),
}
_PARK = np.array([0.0, 20.0, 0.0], np.float32)  # tool parked far above


def _f32(x, device):
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _fwd_from_angle(ang):
    yaw, pitch = float(ang[0]), float(ang[1])
    return np.array([-np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                     -np.cos(yaw) * np.cos(pitch)], dtype=np.float32)


class SimEnv:
    """Push-based deformable manipulation environment on `device` (CUDA
    unless given: with no device and no CUDA device it raises)."""

    _cloth_dims = None  # set per reset; (dimx, dimz) for cloth scenes

    def __init__(self, config, device=None):
        self.device = resolve_device(device)
        d = config["dataset"]
        self.cfg = d
        self.obj = d["obj"]
        self.gripper = bool(d.get("gripper", False))
        self.stick_len = float(d.get("pusher_len", 1.0))
        self.speed = 1.0 / float(d.get("robot_speed_inv", 300))
        self.action_space = float(d.get("action_space", 4.0))
        self.screen = (int(d.get("screenHeight", 720)),
                       int(d.get("screenWidth", 720)))
        self.fps = bool(d.get("fps", False))
        self.fps_number = int(d.get("fps_number", 2000))
        self.rob_obj_dist_thresh = float(d.get("rob_obj_dist_thresh", 0.2))
        self.contact_interval = int(d.get("contact_interval", 40))
        self.non_contact_interval = int(d.get("non_contact_interval", 80))
        self.camera = CameraRig(self.screen[1], self.screen[0])
        self.camera_view = int(d.get("camera_view", 1))
        self.max_chunks = int(d.get("max_chunks", DEFAULT_MAX_CHUNKS))
        self.settle_steps = int(d.get("settle_steps", 200))
        default_group = {"cloth": 1, "granular": 1}.get(self.obj, 8)
        self.chunk_group = max(1, min(int(d.get("chunk_group", default_group)),
                                      self.max_chunks))
        self.caps = MATERIAL_CAPS[self.obj]
        # fuse the shape pass over the first caps.m slots into K1 (K4)
        fuse = d.get("fuse_shapes", os.environ.get("ADAPTIGRAPH_FUSE_SHAPES"))
        self.n_shapes_fused = self.caps.m if fuse and str(fuse) != "0" else None
        # per-scene capacity bucketing (granular): probe-build, then pad to
        # the smallest N_BUCKETS entry that fits
        bc = d.get("bucket_caps", os.environ.get("ADAPTIGRAPH_BUCKET_CAPS", "1"))
        self.bucket_caps = bool(bc) and str(bc) != "0"
        self.caps_ep = self.caps
        self.wkspace_height = 0.5
        self.wkspace_width = 3.5
        self.wkspace_length = 4.5
        # the xArm6: link convex hulls as kinematic collision shapes, their
        # poses from the IK-tracked FK chain
        self.use_robot = bool(d.get("use_robot", True))
        base_lift = 1.0 if self.obj == "cloth" else 0.3
        self.robot_base = np.array(
            [-self.wkspace_width - 0.6, self.wkspace_height + base_lift, 0.0],
            np.float32)
        self._q_rest = np.zeros(6, np.float32)
        self.sampled_idx = None
        # wall seconds and frames of the last plan_push, push and capture
        self.stats = {}

    # ---------- shape construction ----------

    def _tool_slots(self):
        """(kinds, sizes) for the tool shapes in slots 3.. of the shape set."""
        if self.obj == "granular":  # flat board: thin box, width 1.0
            return [SHAPE_BOX], [np.array([0.5, 0.3, 0.04])]
        if self.gripper:  # two finger capsules (axis along local x = vertical)
            return [SHAPE_CAPSULE, SHAPE_CAPSULE], [np.array([0.045, 0.3, 0.0])] * 2
        # stick pusher: capsule of length stick_len
        return [SHAPE_CAPSULE], [np.array([0.06, self.stick_len / 2, 0.0])]

    def _build_shapes(self) -> ShapeSet:
        # tables (flex_env.py:98-126)
        robot_table_h = 0.5 + (1.0 if self.obj == "cloth" else 0.3)
        rtw = 126.0 / 200
        kinds = [SHAPE_PLANE, SHAPE_BOX, SHAPE_BOX]
        sizes = [np.zeros(3),
                 np.array([self.wkspace_width, self.wkspace_height,
                           self.wkspace_length]),
                 np.array([rtw, robot_table_h, rtw])]
        poses = [np.zeros(3), np.zeros(3),
                 np.array([-self.wkspace_width - rtw, 0.0, 0.0])]
        # robot side-table slot, for consumers that hide furniture
        self.table_slot = 2
        tk, ts = self._tool_slots()
        self.tool_slot0 = len(kinds)
        self.n_tool = len(tk)
        kinds += tk
        sizes += ts
        poses += [_PARK] * len(tk)
        quats = [np.array([0.0, 0, 0, 1.0])] * len(kinds)
        planes = [None] * len(kinds)
        self.arm_slot0 = len(kinds)
        self.n_arm = 0
        if self.use_robot:
            assets = robot.load_arm_assets(scale=10.0)
            self.n_arm = len(assets["planes"])
            kinds += [SHAPE_CONVEX] * self.n_arm
            sizes += [np.zeros(3)] * self.n_arm
            planes += assets["planes"]
            # rest pose at the base (settle phase; flex_env rest_joints=0),
            # a host constant taken on the CPU on every device
            lp, lq = robot.link_pose_traj(torch.as_tensor(self._q_rest[None]),
                                          self.robot_base)
            self._rest_link_pos = lp[0].numpy()
            self._rest_link_quat = lq[0].numpy()
            poses += list(self._rest_link_pos)
            quats += list(self._rest_link_quat)
        return make_shapes(kinds, sizes, poses, quats,
                           m_max=max(self.caps.m, len(kinds)), planes=planes,
                           device=self.device)

    def _tool_pose_arrays(self, eef_pos, tool_rot, grip_gap):
        """Tool shape poses ((..., n_tool, 3), (..., n_tool, 4)) for eef
        poses: eef_pos (..., 3) flex-frame tool-base positions, tool_rot
        (..., 3, 3) tool frames (local z points down), grip_gap (...,)
        finger separations; tensors."""
        shapes_pos, shapes_quat = [], []
        down = tool_rot[..., :, 2]  # local z points down (pusher_orientation)
        if self.obj == "granular":
            # board: box y vertical, x the width axis, z the normal
            x_axis = tool_rot[..., :, 0]
            y_axis = -down
            z_axis = torch.linalg.cross(x_axis, y_axis, dim=-1)
            rot = torch.stack([x_axis, y_axis, z_axis], dim=-1)
            shapes_pos.append(eef_pos + down * (self.stick_len - 0.3))
            shapes_quat.append(geo.matrix_to_quat(rot))
        elif self.gripper:
            y_axis = tool_rot[..., :, 1]
            # capsule axis along local x must be vertical: x=down
            rot = torch.stack([down, tool_rot[..., :, 0], tool_rot[..., :, 1]],
                              dim=-1)
            q = geo.matrix_to_quat(rot)
            c = eef_pos + down * (self.stick_len - 0.3)
            for sgn in (1.0, -1.0):
                shapes_pos.append(c + y_axis * (sgn * grip_gap[..., None] / 2))
                shapes_quat.append(q)
        else:
            rot = torch.stack([down, tool_rot[..., :, 0], tool_rot[..., :, 1]],
                              dim=-1)
            shapes_pos.append(eef_pos + down * (self.stick_len / 2))
            shapes_quat.append(geo.matrix_to_quat(rot))
        return torch.stack(shapes_pos, dim=-2), torch.stack(shapes_quat, dim=-2)

    # ---------- reset ----------

    def reset(self, seed: int = 0, save_data: bool = False, settle: bool = True):
        """Build and settle a fresh scene. `settle=False` skips the settle
        (a resumed episode restores its state instead) and leaves
        `finish_reset` to the caller."""
        rng = np.random.RandomState(seed)
        self.rng = np.random.RandomState(seed + 1000003)
        self._q_cur = self._q_rest.copy()
        shapes = self._build_shapes()
        caps = self.caps
        if self.obj == "granular" and self.bucket_caps:
            # right-size the padded capacities to THIS scene: probe-build on
            # the CPU at full caps, pick the smallest bucket that fits,
            # rebuild from an identically seeded rng
            probe = build_scene(self.obj, np.random.RandomState(seed),
                                caps=self.caps, device="cpu")
            cl = probe.spec.clusters
            caps = bucket_caps(probe.n_active, int(cl.valid.sum()),
                               int(cl.member_valid.sum(1).max()), self.caps)
        self.caps_ep = caps
        b = build_scene(self.obj, rng, shapes=shapes, caps=caps,
                        device=self.device)
        self.build = b
        self.state, self.spec = b.state, b.spec
        self.n_active = b.n_active
        self.substeps, self.iterations = b.substeps, b.iterations
        # scenes with no self-colliding particles (granular) skip the
        # rest-distance pair filter
        self.rest_filter = bool(
            b.state.particles.self_collide[: b.n_active].any())
        self.props = b.props
        self._cloth_dims = ((int(b.scene["dimx"]), int(b.scene["dimz"]))
                            if self.obj == "cloth" and "dimx" in b.scene
                            else None)
        self.colors = _f32(np.tile(_PARTICLE_COLORS[self.obj][None],
                                   (caps.n, 1)), self.device)
        self._inv_mass0 = b.state.particles.inv_mass.cpu().numpy()
        self._eef_prev = None
        if not settle:
            return None

        # settle (flex_env.py:246-247), the tool parked and the arm at rest
        n_set = -(-self.settle_steps // CHUNK)
        total = n_set * CHUNK
        st, _, _, _, _ = self._push_fn(
            self.state, self.spec, np.tile(_PARK, (total, 1)),
            np.tile(np.eye(3, dtype=np.float32)[None], (total, 1, 1)),
            np.full(total, 0.4, np.float32), np.zeros(10, np.int64),
            np.zeros((10, 3), np.float32), np.zeros(total, np.float32),
            n_chunks_active=n_set, max_chunks_override=n_set)
        self.state = st
        return self.finish_reset(save_data=save_data)

    def finish_reset(self, save_data: bool = False):
        """Post-settle bookkeeping: FPS storage indices + camera params."""
        if self.fps:
            pts = self.get_positions()
            _, self.sampled_idx = fps_with_idx(pts, self.fps_number)
        else:
            self.sampled_idx = np.arange(self.n_active)

        cam_pos, cam_ang, self.cam_intrinsic_params, self.cam_extrinsic_matrix = (
            self.camera.multiview())
        self._cam_pos, self._cam_ang = cam_pos, cam_ang
        # what every render reads, on the device once a reset
        self._cam_pos_t = _f32(cam_pos, self.device)
        self._cam_fwd_t = _f32(np.stack([_fwd_from_angle(a) for a in cam_ang]),
                               self.device)
        self._intr_t = _f32(self.camera.intrinsics(), self.device)

        data = ([], [], [])  # imgs, particles, eef_states
        if save_data:
            self._store(data, store_tool_pose=self._parked_tool_pose())
        return data

    def _parked_tool_pose(self):
        """The tool's pose while parked (its eef and rotation)."""
        return _PARK, np.eye(3, dtype=np.float32)

    # ---------- the push loop ----------

    def _shape_traj(self, shapes, eef, rot, gap, lp, lq):
        """Every shape slot's pose at every frame, ((T, M, 3), (T, M, 4)):
        the tool slots from the eef poses, the arm slots from the link
        poses, the other slots held where they are."""
        t = eef.shape[0]
        tp, tq = self._tool_pose_arrays(eef, rot, gap)
        pos = shapes.pos.expand((t,) + shapes.pos.shape).clone()
        quat = shapes.quat.expand((t,) + shapes.quat.shape).clone()
        tools = slice(self.tool_slot0, self.tool_slot0 + self.n_tool)
        pos[:, tools], quat[:, tools] = tp, tq
        if self.n_arm:
            arm = slice(self.arm_slot0, self.arm_slot0 + self.n_arm)
            pos[:, arm], quat[:, arm] = lp, lq
        return pos, quat

    def _push_inputs(self, shapes, eef_c, rot_c, gap_c, lp_c, lq_c, att_c,
                     attach_idx, attach_rel, n_active, has_attach):
        """A push's device inputs over its first n_active chunks (the
        per-chunk (mc, CHUNK, ...) arrays of _push_fn): every shape slot's
        pose at every frame, and the attachment (eef, rotation, on flag,
        indices, offsets) or None on the attach-free path."""
        dev = self.device
        run = slice(0, n_active)
        eef_d = _f32(eef_c[run].reshape(-1, 3), dev)
        rot_d = _f32(rot_c[run].reshape(-1, 3, 3), dev)
        traj = self._shape_traj(
            shapes, eef_d, rot_d, _f32(gap_c[run].reshape(-1), dev),
            _f32(lp_c[run].reshape(-1, self.n_arm, 3), dev),
            _f32(lq_c[run].reshape(-1, self.n_arm, 4), dev))
        attach = None
        if has_attach:
            attach = (eef_d, rot_d, _f32(att_c[run].reshape(-1), dev) > 0,
                      torch.as_tensor(np.asarray(attach_idx),
                                      dtype=torch.int64, device=dev),
                      _f32(attach_rel, dev))
        return traj, attach

    def _push_group(self, st, spec, lo, hi, traj, attach):
        """Chunks lo..hi-1 of a push, frame by frame: the body of one JAX
        group program. The attach-free path packs its contact tables once;
        the attach path moves the grasped particles with the tool each frame
        (and xpbd_step packs its tables each frame). Returns (state, the
        positions at each chunk end (hi - lo, N, 3) on the device, the
        explosion guard: NaN, escape beyond 1e3 or a grown contact_overflow,
        a device bool)."""
        pos_traj, quat_traj = traj
        overflow0 = torch.as_tensor(st.contact_overflow, device=self.device)
        tables0 = (pack_tables_for(st.particles, spec) if attach is None
                   else None)
        recs = []
        for t in range(lo * CHUNK, hi * CHUNK):
            st = st._replace(shapes=st.shapes.moved_to(pos_traj[t],
                                                       quat_traj[t]))
            if attach is not None:
                # attachment: move the grasped particles with the tool
                eef_d, rot_d, att_on, a_idx, a_rel = attach
                p = st.particles
                apos = eef_d[t][None, :] + (rot_d[t] @ a_rel.T).T
                tgt = torch.where(att_on[t], apos, p.pos[a_idx])
                w = torch.where(att_on[t], 0.0, p.inv_mass[a_idx])
                st = st._replace(particles=p._replace(
                    pos=p.pos.index_put((a_idx,), tgt),
                    inv_mass=p.inv_mass.index_put((a_idx,), w)))
            st = xpbd_step(st, spec, self.substeps, self.iterations,
                           rest_filter=self.rest_filter,
                           n_shapes_active=self.n_shapes_fused,
                           packed_tables=tables0)
            if (t + 1) % CHUNK == 0:
                recs.append(st.particles.pos)
        p = st.particles
        bad = (torch.isnan(p.pos[:, 0]).any()
               | (torch.abs(torch.where(p.active[:, None], p.pos, 0.0)).amax()
                  > 1e3)
               | (torch.as_tensor(st.contact_overflow, device=self.device)
                  > overflow0))
        return st, torch.stack(recs), bad

    def _chunked(self, mc, eef_traj, rot_traj, gap_traj, attach_active,
                 link_pos_traj, link_quat_traj):
        """A push's per-frame arrays as (mc, CHUNK, ...) chunks; no link
        track (arm off or parked) holds the rest pose."""
        total = mc * CHUNK
        if link_pos_traj is None:
            if self.n_arm:
                link_pos_traj = np.tile(self._rest_link_pos[None], (total, 1, 1))
                link_quat_traj = np.tile(self._rest_link_quat[None],
                                         (total, 1, 1))
            else:
                link_pos_traj = np.zeros((total, 0, 3), np.float32)
                link_quat_traj = np.zeros((total, 0, 4), np.float32)
        return (np.asarray(eef_traj).reshape(mc, CHUNK, 3),
                np.asarray(rot_traj).reshape(mc, CHUNK, 3, 3),
                np.asarray(gap_traj).reshape(mc, CHUNK),
                np.asarray(link_pos_traj).reshape(mc, CHUNK, self.n_arm, 3),
                np.asarray(link_quat_traj).reshape(mc, CHUNK, self.n_arm, 4),
                np.asarray(attach_active).reshape(mc, CHUNK))

    def _push_fn(self, state, spec, eef_traj, rot_traj, gap_traj, attach_idx,
                 attach_rel, attach_active, n_chunks_active=None,
                 max_chunks_override=None, link_pos_traj=None,
                 link_quat_traj=None, attach_path=None):
        """Host loop over chunk groups: runs only the chunks the push (and
        settle) needs, stops after a group the guard flags, and pads the
        remaining records with the last one. `attach_path`: run the grasp
        path (per-frame attachment and table pack); None takes it iff an
        attachment is active. Returns (state, positions at each chunk end
        (mc, N, 3), eef and tool rotation at each chunk end, [exploded])."""
        t0 = time.perf_counter()
        g = self.chunk_group
        mc = max_chunks_override or self.max_chunks
        eef_c, rot_c, gap_c, lp_c, lq_c, att_c = self._chunked(
            mc, eef_traj, rot_traj, gap_traj, attach_active, link_pos_traj,
            link_quat_traj)
        n_active = n_chunks_active or mc
        n_groups = -(-n_active // g)
        # a host-side fact: only grasp pushes mutate inv_mass mid-push
        has_attach = (bool(np.any(att_c[:n_active])) if attach_path is None
                      else attach_path)
        traj, attach = self._push_inputs(state.shapes, eef_c, rot_c, gap_c,
                                         lp_c, lq_c, att_c, attach_idx,
                                         attach_rel, n_active, has_attach)
        pos_rec, nan_any = [], False
        st = state
        for gi in range(n_groups):
            lo, hi = gi * g, min(gi * g + g, n_active)
            st, recs, bad = self._push_group(st, spec, lo, hi, traj, attach)
            # the loop's only host sync: the group's records and its guard
            pos_rec.extend(recs.cpu().numpy())
            if bool(bad):
                nan_any = True
                break
        while len(pos_rec) < mc:
            pos_rec.append(pos_rec[-1])
        self._gap_rec = gap_c[:, -1]
        self._link_rec = (lp_c[:, -1], lq_c[:, -1])
        frames = min(hi, n_active) * CHUNK
        self.stats["push"] = {"frames": frames,
                              "seconds": time.perf_counter() - t0}
        return (st, np.stack(pos_rec[:mc]), eef_c[:, -1], rot_c[:, -1],
                np.array([nan_any]))

    # ---------- step ----------

    def scripted_track(self, action):
        """The push's scripted tool track, before IK: (eef targets (total,
        3) in the flex frame, tool rotation (3, 3), waypoint segment of
        each frame (total,), push frames t_push, the start waypoint). The
        waypoints are interpolated at robot speed (flex_env.py:289-295) and
        held at the final retracted pose to the trajectory's end."""
        h = self.wkspace_height + self.stick_len
        s = np.array([action[0], action[1], h])  # (x, z_action, height)
        e = np.array([action[2], action[3], h])
        d = s[:2] - e[:2]
        pusher_angle = np.pi / 2 if d[0] == 0 else np.arctan(d[1] / d[0])

        if self.gripper:
            wps = [s + [0, 0, 0.5], s, s, e + [0, 0, 0.5], e]
        else:
            wps = [s + [0, 0, 0.2], s, e, e + [0, 0, 0.2]]

        eef_list, seg_id = [], []
        for i_p in range(len(wps) - 1):
            a, b = wps[i_p], wps[i_p + 1]
            steps = int(np.linalg.norm(b - a) / self.speed) + 1
            for i in range(steps):
                eef_list.append(a + (b - a) * i / steps)
                seg_id.append(i_p)
        traj = np.array(eef_list, dtype=np.float32)
        seg_id = np.array(seg_id)
        t_push = len(traj)
        total = self.max_chunks * CHUNK
        if t_push > total - self.settle_steps:
            keep = total - self.settle_steps
            traj, seg_id = traj[:keep], seg_id[:keep]
            t_push = keep
        pad = total - t_push
        traj = np.concatenate([traj, np.tile(traj[-1][None], (pad, 1))], 0)
        seg_id = np.concatenate([seg_id, np.full(pad, seg_id[-1])])
        # action frame -> flex frame: (x, z_a, h) -> (x, h, -z_a)
        eef_flex = np.stack([traj[:, 0], traj[:, 2], -traj[:, 1]], 1)
        rot = robot.pusher_orientation(np.float32(pusher_angle)).numpy()
        return eef_flex, rot, seg_id, t_push, s

    def plan_push(self, action):
        """Decode the 4-dof action into per-frame arrays (eef, tool
        rotation, gripper gap, attachment, arm link poses). Returns a dict
        of (total,)-leading numpy arrays + scalars."""
        t0 = time.perf_counter()
        eef_flex, rot, seg_id, t_push, s = self.scripted_track(action)
        total = self.max_chunks * CHUNK
        rot_traj = np.tile(rot[None], (total, 1, 1)).astype(np.float32)

        # IK-track the arm along the scripted eef trajectory before the sim
        # loop; the tool then follows the FK chain, so physics, rendering
        # and recorded eef states agree
        lp_traj = lq_traj = q_final = None
        t_ik = 0.0
        if self.use_robot:
            t1 = time.perf_counter()
            q_traj = robot.ik_traj(eef_flex, rot_traj, self._q_cur,
                                   self.robot_base, device=self.device)
            lp, lq = robot.link_pose_traj(q_traj, self.robot_base)
            rt = geo.quat_to_matrix(lq[:, -1])
            lp_traj, lq_traj = lp.cpu().numpy(), lq.cpu().numpy()
            q_final = q_traj[-1].cpu().numpy()
            eef_flex = lp_traj[:, -1]
            rot_traj = rt.cpu().numpy()
            t_ik = time.perf_counter() - t1

        # gripper schedule
        gap_traj = np.full(total, 0.4, np.float32)
        attach_active = np.zeros(total, np.float32)
        attach_idx = np.zeros(10, np.int64)
        attach_rel = np.zeros((10, 3), np.float32)
        if self.gripper:
            grasp_t = int(np.nonzero(seg_id >= 1)[0][0]) if (seg_id >= 1).any() else 0
            # close over 50 frames but never past the push end
            close_t = min(grasp_t + 50, total, max(t_push - 1, grasp_t + 1))
            gap_traj[grasp_t:close_t] = np.linspace(0.4, 0.05, close_t - grasp_t)
            gap_traj[close_t:t_push] = 0.05
            release_t = t_push
            attach_active[close_t:release_t] = 1.0
            # pick k=5 nearest particles to the grasp point (flex_env.py:330-336)
            grasp_world = np.array([s[0], s[2] - self.stick_len, -s[1]], np.float32)
            pts = self.get_positions()
            near = np.argsort(np.linalg.norm(pts - grasp_world, axis=1))[:5]
            attach_idx = np.concatenate([near, near]).astype(np.int64)[:10]
            # offsets in tool frame: from eef to the particle at grasp time
            eef0 = eef_flex[grasp_t]
            attach_rel = ((pts[attach_idx % self.n_active] - eef0)
                          @ rot_traj[grasp_t]).astype(np.float32)

        self.stats["plan"] = {"frames": total, "ik_seconds": t_ik,
                              "seconds": time.perf_counter() - t0}
        # q_final is committed to self._q_cur only when the push runs
        return {"eef": eef_flex.astype(np.float32), "rot": rot_traj,
                "gap": gap_traj, "attach_active": attach_active,
                "attach_idx": attach_idx, "attach_rel": attach_rel,
                "link_pos": lp_traj, "link_quat": lq_traj, "t_push": t_push,
                "q_final": q_final}

    def step(self, action, save_data: bool = False, data=None):
        """Execute one push. Returns (obs_img, data) or None on explosion."""
        if data is None:
            data = ([], [], [])
        plan = self.plan_push(action)
        t_push = plan["t_push"]
        attach_idx = plan["attach_idx"]
        n_chunks_active = min(-(-(t_push + self.settle_steps) // CHUNK),
                              self.max_chunks)
        st, pos_rec, eef_rec, rot_rec, nan_rec = self._push_fn(
            self.state, self.spec, plan["eef"], plan["rot"], plan["gap"],
            attach_idx, plan["attach_rel"], plan["attach_active"],
            n_chunks_active=n_chunks_active,
            link_pos_traj=plan["link_pos"], link_quat_traj=plan["link_quat"])

        if bool(np.asarray(nan_rec).any()):
            print("simulator exploded when action is", action)
            return None
        if plan["q_final"] is not None:  # push executed: commit the IK state
            self._q_cur = plan["q_final"]
        # restore grasped particle mass (flex_env.py:384-388)
        if self.gripper:
            idx = torch.as_tensor(attach_idx, device=self.device)
            w = st.particles.inv_mass.index_put(
                (idx,), _f32(self._inv_mass0[attach_idx], self.device))
            st = st._replace(particles=st.particles._replace(inv_mass=w))
        self.state = st

        if save_data:
            self._capture_push(data, pos_rec, eef_rec, rot_rec, t_push)

        obs = self.render()
        return obs, data

    def _select_captures(self, pos_rec, eef_rec, t_push):
        """The chunk boundaries to capture: the contact-gated cadence during
        the push (flex_env.py:369-376 at CHUNK granularity), and only the
        final frame during the settle."""
        n_chunks_active = min((t_push + CHUNK - 1) // CHUNK, self.max_chunks)
        selected = []
        for ci in range(self.max_chunks):
            step_idx = (ci + 1) * CHUNK
            pts = pos_rec[ci][: self.n_active]
            eef = eef_rec[ci]
            dist = np.min(np.linalg.norm(pts[:, [0, 2]] - eef[None, [0, 2]],
                                         axis=1))
            if ci < n_chunks_active:
                in_contact = dist < self.rob_obj_dist_thresh
                interval = (self.contact_interval if in_contact
                            else self.non_contact_interval)
                if step_idx % interval != 0:
                    continue
            elif ci != self.max_chunks - 1:
                continue
            selected.append(ci)
        return selected

    def _capture_push(self, data, pos_rec, eef_rec, rot_rec, t_push):
        """Record the selected chunk boundaries' frames."""
        self._cap_eef, self._cap_rot = eef_rec, rot_rec
        selected = self._select_captures(pos_rec, eef_rec, t_push)
        if not selected:
            return
        imgs = self._render_capture_batch(pos_rec, selected)
        for k, ci in enumerate(selected):
            self._store(data, particles=pos_rec[ci],
                        store_tool_pose=(eef_rec[ci], rot_rec[ci]),
                        imgs=imgs[k])

    def _render_capture_batch(self, pos_rec, selected):
        """Quantised (color_u8, depth_u16) frame pairs for the selected
        chunk boundaries x 4 cameras, rendered on the device. Returns a
        list of F (color (4, H, W, 3) u8, depth (4, H, W) u16)."""
        t0 = time.perf_counter()
        H, W = self.screen
        f = len(selected)
        shs = [self._shapes_at(ci) for ci in selected]
        color, depth = quantize_frames(render_frames_batch(
            _f32(np.stack([pos_rec[ci] for ci in selected]), self.device),
            self.colors, self.state.particles.active.expand(f, -1),
            self.state.shapes, torch.stack([s.pos for s in shs]),
            torch.stack([s.quat for s in shs]), self._cam_pos_t,
            self._cam_fwd_t, self._intr_t, width=W, height=H,
            cloth_dims=self._cloth_dims))
        self.stats["capture"] = {"frames": f, "cameras": len(self._cam_pos),
                                 "seconds": time.perf_counter() - t0}
        return [(color[k], depth[k]) for k in range(f)]

    def _shapes_at(self, ci):
        """Shape set posed as it was at chunk boundary `ci`, so captured
        frames show the tool and arm where they were."""
        dev = self.device
        tp, tq = self._tool_pose_arrays(_f32(self._cap_eef[ci], dev),
                                        _f32(self._cap_rot[ci], dev),
                                        _f32(self._gap_rec[ci], dev))
        shapes = self.state.shapes
        pos, quat = shapes.pos.clone(), shapes.quat.clone()
        tools = slice(self.tool_slot0, self.tool_slot0 + self.n_tool)
        pos[tools], quat[tools] = tp, tq
        if self.n_arm:
            lp, lq = self._link_rec
            arm = slice(self.arm_slot0, self.arm_slot0 + self.n_arm)
            pos[arm], quat[arm] = _f32(lp[ci], dev), _f32(lq[ci], dev)
        return shapes._replace(pos=pos, quat=quat)

    # ---------- capture / render ----------

    def _eef_states_from_pose(self, eef, rot):
        """(n_eef, 14) shape-state rows for the tool link(s): pos, prev_pos,
        quat, prev_quat (the pyflex shape-state schema preprocessing reads).
        Link positions are placed so the config's eef offsets land on the
        tool's interaction point."""
        rotm = np.asarray(rot, np.float32)
        pos = np.asarray(eef, np.float32)
        quat = geo.matrix_to_quat(torch.as_tensor(rotm)).numpy()
        if self.gripper:
            # finger links 1.2 below the base at -+0.2 lateral
            z_link = self.stick_len - 0.6
            link_pos = [pos + rotm @ np.array([0.0, +0.2, z_link]),
                        pos + rotm @ np.array([0.0, -0.2, z_link])]
        else:
            link_pos = [pos]
        if self._eef_prev is None:
            prev, prev_quat = link_pos, quat
        else:
            prev, prev_quat = self._eef_prev
        rows = [np.concatenate([p, pp, quat, prev_quat]).astype(np.float32)
                for p, pp in zip(link_pos, prev)]
        self._eef_prev = (link_pos, quat)
        return np.stack(rows)

    def _store(self, data, particles=None, store_tool_pose=None, imgs=None):
        imgs_list, particle_list, eef_list = data
        if particles is None:
            particles = self.state.particles.pos.cpu().numpy()
        particle_list.append(particles[self.sampled_idx].copy()
                             if self.fps else particles[: self.n_active].copy())
        eef, rot = store_tool_pose
        eef_list.append(self._eef_states_from_pose(eef, rot))
        if imgs is None:
            f = self._render_multiview(particles)  # (4, H, W, 5)
            imgs = ((np.clip(f[..., :3], 0.0, 1.0) * 255).astype(np.uint8),
                    (f[..., 4] * 1000).astype(np.uint16))
        imgs_list.append(imgs)

    def _render_multiview(self, particles, shapes=None):
        """(4, H, W, 5) float frames of `particles` from the 4 cameras, with
        `shapes` (the env's own shape set when None)."""
        H, W = self.screen
        pos = _f32(particles, self.device)
        if shapes is None:
            shapes = self.state.shapes
        return np.stack([render_frame(
            pos, self.colors, self.state.particles.active, shapes,
            self._cam_pos_t[ci], self._cam_fwd_t[ci], self._intr_t,
            width=W, height=H, cloth_dims=self._cloth_dims).cpu().numpy()
            for ci in range(4)])

    def render(self, no_return: bool = False):
        if no_return:
            return None
        H, W = self.screen
        pos, ang = self.camera.single_view(self.camera_view)
        f = render_frame(self.state.particles.pos, self.colors,
                         self.state.particles.active, self.state.shapes,
                         _f32(pos, self.device),
                         _f32(_fwd_from_angle(ang), self.device),
                         self._intr_t, width=W, height=H,
                         cloth_dims=self._cloth_dims)
        return f.cpu().numpy()

    # ---------- action sampling ----------

    def get_positions(self):
        return self.state.particles.pos[: self.n_active].cpu().numpy()

    def get_property_params(self):
        return self.props

    def sample_action(self, init=False, boundary_points=None, boundary=None):
        if self.obj in ("rope", "granular"):
            return self.sample_deform_actions()
        elif self.obj == "cloth":
            return self.sample_grasp_actions_corner(init, boundary_points, boundary)
        raise ValueError(f"no action sampler for {self.obj}")

    def sample_deform_actions(self):
        """Push toward a central object point from a free start
        (flex_env.py:424-470 semantics)."""
        positions = self.get_positions().copy()
        positions[:, 2] *= -1  # flex z -> action frame
        pos_xz = positions[:, [0, 2]]
        center = np.median(pos_xz, axis=0)
        chosen = np.nonzero(np.linalg.norm(pos_xz - center, axis=1) < 2.0)[0]
        if len(chosen) == 0:
            chosen = np.arange(len(positions))
        for _ in range(1000):
            start = self.rng.uniform(-self.action_space, self.action_space, size=2)
            pick = self.rng.choice(chosen)
            obj_pos = pos_xz[pick]
            if obj_pos[0] == start[0]:
                continue
            slope = (obj_pos[1] - start[1]) / (obj_pos[0] - start[0])
            x_end = obj_pos[0] + (1.0 if obj_pos[0] >= start[0] else -1.0)
            y_end = slope * (x_end - start[0]) + start[1]
            if (abs(x_end) < 1.5 and abs(y_end) < 1.5
                    and np.min(np.linalg.norm(pos_xz - start[None], axis=1)) > 0.2):
                return np.array([start[0], start[1], x_end, y_end])
        return None

    def sample_grasp_actions_corner(self, init=False, boundary_points=None,
                                    boundary=None):
        """Grasp a cloth boundary point and pull outward (flex_env.py:472-525)."""
        positions = self.get_positions().copy()
        positions[:, 2] *= -1
        x, z = positions[:, 0], positions[:, 2]
        if init:
            boundary_points, boundary = [], []
            for idx in range(len(positions)):
                if x[idx] == x.max():
                    boundary_points.append(idx)
                    boundary.append(1)
                elif x[idx] == x.min():
                    boundary_points.append(idx)
                    boundary.append(2)
                elif z[idx] == z.max():
                    boundary_points.append(idx)
                    boundary.append(3)
                elif z[idx] == z.min():
                    boundary_points.append(idx)
                    boundary.append(4)
        action = None
        for _ in range(1000):
            pick = self.rng.choice(len(boundary_points))
            start = positions[boundary_points[pick]][[0, 2]]
            end = start.copy()
            move = self.rng.uniform(1.0, 1.5)
            side = boundary[pick]
            if side == 1:
                end[0] += move
            elif side == 2:
                end[0] -= move
            elif side == 3:
                end[1] += move
            else:
                end[1] -= move
            if abs(end[0]) < 3.5 and abs(end[1]) < 2.5:
                action = np.concatenate([start, end])
                break
        return action, boundary_points, boundary

    def close(self):
        pass
