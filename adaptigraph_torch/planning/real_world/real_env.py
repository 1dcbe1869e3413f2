"""Real-robot environment: xArm6 + multi-camera rig behind the planning
API; the port of adaptigraph_tpu/planning/real_world/real_env.py (numpy;
cv2 imported by the calibrations only).

As the reference's src/planning/real_world/real_env.py (RealEnv
:22-569): camera
processes + shared-memory transport, ArUco fixed-camera calibration
(:462-538), robot-world hand-eye registration hook (:328-460), and the push
primitives — approach above the start point, descend, push along the
segment, lift (:212-240); gripper variant grasps between descend and move
(:242-276). Workspace clipping keeps commanded poses above the table.

`use_robot=False` runs the same code against FakeXarm + SimCameraBackend —
the hardware-free double (real_env.py:79-83's pattern) used by tests.

Frames: planning/table frame (x, z) in meters; `T_table_base` maps table
points into the robot base frame (from calibration). sim <-> real scale is
sim_real_ratio=10 (1 sim unit = 10 cm).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from adaptigraph_torch.planning.real_world.cameras import (
    MultiCamera, RealsenseBackend, SimCameraBackend)


def rpy_to_rotation(roll_deg, pitch_deg, yaw_deg) -> np.ndarray:
    """xArm rpy (degrees, Rz@Ry@Rx) -> rotation matrix
    (reference real_world/utils.py:5-16)."""
    r, p, y = np.deg2rad([roll_deg, pitch_deg, yaw_deg])
    rx = np.array([[1, 0, 0], [0, np.cos(r), -np.sin(r)], [0, np.sin(r), np.cos(r)]])
    ry = np.array([[np.cos(p), 0, np.sin(p)], [0, 1, 0], [-np.sin(p), 0, np.cos(p)]])
    rz = np.array([[np.cos(y), -np.sin(y), 0], [np.sin(y), np.cos(y), 0], [0, 0, 1]])
    return rz @ ry @ rx


def _estimate_board_pose(gray, intr4, board_shape, marker_len_m):
    """ArUco grid pose in the camera frame: (R_board2cam, t) or None.
    Mirrors real_env.py:373-404 (detect -> refine -> estimatePoseBoard),
    expressed against the same synthetic board layout `calibrate` uses."""
    import cv2

    aruco = cv2.aruco
    dictionary = aruco.getPredefinedDictionary(aruco.DICT_4X4_50)
    detector = aruco.ArucoDetector(dictionary)
    corners, ids, _ = detector.detectMarkers(gray)
    if ids is None or len(ids) < 4:
        return None
    cols = board_shape[0]
    objp, imgp = [], []
    for c, mid in zip(corners, ids.ravel()):
        gx, gy = mid % cols, mid // cols
        ox, oy = gx * marker_len_m * 1.5, gy * marker_len_m * 1.5
        objp.extend([[ox, 0, oy], [ox + marker_len_m, 0, oy],
                     [ox + marker_len_m, 0, oy + marker_len_m],
                     [ox, 0, oy + marker_len_m]])
        imgp.extend(c.reshape(4, 2))
    fx, fy, cx, cy = intr4
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    ok, rvec, tvec = cv2.solvePnP(np.asarray(objp, np.float64),
                                  np.asarray(imgp, np.float64), k, None)
    if not ok:
        return None
    r, _ = cv2.Rodrigues(rvec)
    return r, tvec.ravel()


def _project_so3(m):
    """Nearest rotation matrix (Frobenius) via SVD."""
    u, _, vt = np.linalg.svd(m)
    r = u @ vt
    if np.linalg.det(r) < 0:
        r = u @ np.diag([1.0, 1.0, -1.0]) @ vt
    return r


def solve_robot_world_handeye(r_board2cam, t_board2cam, r_gripper2base,
                              t_gripper2base):
    """Robot-world hand-eye calibration (the reference drives
    cv2.calibrateRobotWorldHandEye, real_env.py:419-446).

    Solves A_i Z = Y B_i with A_i = board(world)->cam, B_i = base->gripper,
    Z = base->world, Y = gripper->cam, using Shah's linear Kronecker method
    ("Solving the robot-world/hand-eye calibration problem using the
    Kronecker product", 2013): R_Ai R_Z R_Bi^T = R_Y for every view, so the
    dominant singular pair of M = sum_i (R_Bi (x) R_Ai) gives vec(R_Y) /
    vec(R_Z); translations follow from one least squares. Implemented
    natively (this image's OpenCV build lacks calibrateRobotWorldHandEye).

    Returns (T_table_base (4, 4) — board/world frame into the robot base —
    and T_gripper_cam (4, 4)). Pure function: testable without hardware."""
    r_a = [np.asarray(r, np.float64) for r in r_board2cam]
    t_a = [np.asarray(t, np.float64).ravel() for t in t_board2cam]
    r_b = [np.asarray(r, np.float64).T for r in r_gripper2base]   # base->gripper
    t_b = [-rb @ np.asarray(t, np.float64).ravel()
           for rb, t in zip(r_b, t_gripper2base)]

    m = np.zeros((9, 9))
    for ra, rb in zip(r_a, r_b):
        m += np.kron(rb, ra)
    u, _, vt = np.linalg.svd(m)
    # column-major vec: unflatten with order='F'
    ry_raw = u[:, 0].reshape(3, 3, order="F")
    rz_raw = vt[0].reshape(3, 3, order="F")
    s = np.sign(np.linalg.det(ry_raw)) or 1.0
    r_y = _project_so3(ry_raw * s)
    r_z = _project_so3(rz_raw * s)

    # R_Ai t_Z - t_Y = R_Y t_Bi - t_Ai  (stacked least squares)
    lhs = np.concatenate(
        [np.concatenate([ra, -np.eye(3)], axis=1) for ra in r_a], axis=0)
    rhs = np.concatenate([r_y @ tb - ta for ta, tb in zip(t_a, t_b)])
    sol, *_ = np.linalg.lstsq(lhs, rhs, rcond=None)
    t_z, t_y = sol[:3], sol[3:]

    t_base_world = np.eye(4)
    t_base_world[:3, :3] = r_z
    t_base_world[:3, 3] = t_z
    t_table_base = np.linalg.inv(t_base_world)  # world/table -> base
    t_gripper_cam = np.eye(4)
    t_gripper_cam[:3, :3] = r_y
    t_gripper_cam[:3, 3] = t_y
    return t_table_base, t_gripper_cam


class RealEnv:
    units = "real"  # get_obs depths are metric; plan.py scales states

    def __init__(self, task_config=None, use_robot: bool = True,
                 use_real_cameras: bool = True, camera_serials=None,
                 robot_ip: str = "192.168.1.209", resolution=(720, 720),
                 calib_dir: str = "dump/calibration"):
        self.task_config = task_config or {}
        self.use_robot = use_robot
        self.resolution = resolution
        self.calib_dir = calib_dir
        self.push_height = float(self.task_config.get("clipping_height", -0.06))
        self.approach_height = 0.15  # meters above the table for transit
        self.sim_real_ratio = float(self.task_config.get("sim_real_ratio", 10.0))

        if use_real_cameras:
            serials = camera_serials or []
            backends = {f"cam_{i}": RealsenseBackend(s, resolution)
                        for i, s in enumerate(serials)}
        else:
            backends = {f"cam_{i}": SimCameraBackend(resolution) for i in range(4)}
        self.cameras = MultiCamera(backends, resolution)

        if use_robot:
            from adaptigraph_torch.planning.real_world.xarm6 import (
                XarmController)

            self.robot = XarmController(robot_ip)
        else:
            from adaptigraph_torch.planning.real_world.xarm6 import FakeXarm

            self.robot = FakeXarm()

        # table->base: identity until calibrated/loaded
        self.T_table_base = np.eye(4)
        self.cam_intr = None
        self.cam_extr = None

    # ---------- lifecycle ----------

    def start(self, wait_ready: float = 5.0):
        ok = self.cameras.start(wait_ready)
        if not ok:
            raise RuntimeError("cameras failed to become ready")
        self._load_calibration()
        return self

    def stop(self):
        self.cameras.stop()
        self.robot.close()

    # ---------- observation ----------

    def get_obs(self):
        """Timestamp-aligned frames: (colors (n,H,W,3) uint8,
        depths (n,H,W) float meters)."""
        frames = self.cameras.get_obs()
        names = sorted(frames.keys())
        colors = np.stack([frames[n]["color"] for n in names])
        depths = np.stack([frames[n]["depth"] for n in names]).astype(np.float32) / 1000.0
        return colors, depths

    # ---------- calibration ----------

    def calibrate(self, board_shape=(5, 7), marker_len_m: float = 0.03,
                  save: bool = True):
        """Fixed-camera extrinsics from an ArUco board on the table
        (real_env.py:462-538): detect markers per camera, solvePnP against
        the known board layout, store world(table)->camera transforms."""
        import cv2

        aruco = cv2.aruco
        dictionary = aruco.getPredefinedDictionary(aruco.DICT_4X4_50)
        colors, _ = self.get_obs()
        n = len(colors)
        extr = np.tile(np.eye(4, dtype=np.float32)[None], (n, 1, 1))
        intr = np.zeros((n, 4), np.float32)
        for i, (name, cam) in enumerate(sorted(self.cameras.cams.items())):
            intr[i] = cam.backend.get_intrinsics()
            gray = cv2.cvtColor(colors[i], cv2.COLOR_RGB2GRAY)
            detector = aruco.ArucoDetector(dictionary)
            corners, ids, _ = detector.detectMarkers(gray)
            if ids is None or len(ids) == 0:
                continue  # leave identity; caller decides validity
            objp, imgp = [], []
            cols = board_shape[0]
            for c, mid in zip(corners, ids.ravel()):
                gx, gy = mid % cols, mid // cols
                ox, oy = gx * marker_len_m * 1.5, gy * marker_len_m * 1.5
                objp.extend([[ox, 0, oy], [ox + marker_len_m, 0, oy],
                             [ox + marker_len_m, 0, oy + marker_len_m],
                             [ox, 0, oy + marker_len_m]])
                imgp.extend(c.reshape(4, 2))
            fx, fy, cx, cy = intr[i]
            k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
            ok, rvec, tvec = cv2.solvePnP(np.asarray(objp, np.float64),
                                          np.asarray(imgp, np.float64), k, None)
            if ok:
                r, _ = cv2.Rodrigues(rvec)
                extr[i, :3, :3] = r
                extr[i, :3, 3] = tvec.ravel()
        self.cam_intr, self.cam_extr = intr, extr
        if save:
            os.makedirs(self.calib_dir, exist_ok=True)
            with open(os.path.join(self.calib_dir, "calibration.pkl"), "wb") as f:
                pickle.dump({"intr": intr, "extr": extr,
                             "T_table_base": self.T_table_base}, f)
        return intr, extr

    # xarm wrist poses (base-frame mm + rpy deg) spanning the calibration
    # board from varied viewpoints — real_env.py:331-343
    HANDEYE_POSES = [
        [522.6, -1.6, 279.5, 179.2, 0, 0.3],
        [494.3, 133, 279.5, 179.2, 0, -24.3],
        [498.8, -127.3, 314.9, 179.3, 0, 31.1],
        [589.5, 16.6, 292.9, -175, 17, 1.2],
        [515.8, 178.5, 469.2, -164.3, 17.5, -90.8],
        [507.9, -255.5, 248.5, -174.6, -16.5, 50.3],
        [507.9, 258.2, 248.5, -173.5, -8, -46.8],
        [569, -155.6, 245.8, 179.5, 3.7, 49.7],
        [570.8, -1.2, 435, -178.5, 52.3, -153.9],
        [474.3, 12.5, 165.3, 179.3, -15, 0.3],
    ]

    def calibrate_handeye(self, wrist_cam: str | None = None, poses=None,
                          board_shape=(5, 7), marker_len_m: float = 0.03,
                          save: bool = True):
        """Robot-world hand-eye calibration (real_env.py:328-460): drive the
        wrist camera over `poses`, estimate the board pose per view, pair it
        with the commanded gripper pose, and solve
        cv2.calibrateRobotWorldHandEye (TSAI) for base->world; T_table_base
        (world/table -> base) is its inverse and immediately becomes the
        push-primitive transform."""
        import cv2

        poses = poses or self.HANDEYE_POSES
        wrist_cam = wrist_cam or sorted(self.cameras.cams.keys())[-1]
        cam = self.cameras.cams[wrist_cam]
        r_g2b, t_g2b, r_b2c, t_b2c = [], [], [], []
        for pose in poses:
            self.robot.move_to_pose(pose, wait=True)
            frames = self.cameras.get_obs()
            gray = cv2.cvtColor(frames[wrist_cam]["color"], cv2.COLOR_RGB2GRAY)
            intr = cam.backend.get_intrinsics()
            est = _estimate_board_pose(gray, intr, board_shape, marker_len_m)
            if est is None:
                continue
            r_bc, t_bc = est
            r_b2c.append(r_bc)
            t_b2c.append(t_bc)
            r_g2b.append(rpy_to_rotation(pose[3], pose[4], pose[5]))
            t_g2b.append(np.asarray(pose[:3], np.float64) / 1000.0)
        if len(r_g2b) < 3:
            raise RuntimeError(
                f"hand-eye needs >=3 usable views, got {len(r_g2b)}")
        t_table_base, t_gripper_cam = solve_robot_world_handeye(
            r_b2c, t_b2c, r_g2b, t_g2b)
        self.T_table_base = t_table_base
        if save:
            os.makedirs(self.calib_dir, exist_ok=True)
            with open(os.path.join(self.calib_dir,
                                   "calibration_handeye.pkl"), "wb") as f:
                pickle.dump({"T_table_base": t_table_base,
                             "T_gripper_cam": t_gripper_cam}, f)
        return t_table_base, t_gripper_cam

    def _load_calibration(self):
        path = os.path.join(self.calib_dir, "calibration.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                d = pickle.load(f)
            self.cam_intr = d["intr"]
            self.cam_extr = d["extr"]
            self.T_table_base = d.get("T_table_base", np.eye(4))
        he = os.path.join(self.calib_dir, "calibration_handeye.pkl")
        if os.path.exists(he):
            with open(he, "rb") as f:
                self.T_table_base = pickle.load(f)["T_table_base"]

    # ---------- motion primitives ----------

    def _table_to_base_mm(self, p_table_m):
        """Table-frame meters -> base-frame mm, clipped above the table
        (real_env.py:212-240's transform + collision clipping)."""
        p = np.asarray([p_table_m[0], p_table_m[1], p_table_m[2], 1.0])
        q = self.T_table_base @ p
        q[2] = max(q[2], self.push_height)
        return q[:3] * 1000.0

    def step(self, action4_sim):
        """Pusher primitive: action in SIM units [xs, zs, xe, ze] ->
        approach -> descend -> push -> lift."""
        a = np.asarray(action4_sim, np.float64) / self.sim_real_ratio
        start = np.array([a[0], a[1], self.push_height])
        end = np.array([a[2], a[3], self.push_height])
        orn = [180.0, 0.0, np.degrees(np.arctan2(end[1] - start[1],
                                                 end[0] - start[0]))]
        hi = self.approach_height
        ok = True
        for wp in (np.r_[start[:2], self.push_height + hi], start, end,
                   np.r_[end[:2], self.push_height + hi]):
            pos = self._table_to_base_mm(wp)
            ok &= self.robot.move_to_pose([*pos, *orn], wait=True)
            if not self.robot.is_alive:
                raise RuntimeError("xarm reported an error during push")
        return ok

    def step_gripper(self, action4_sim):
        """Grasp primitive (real_env.py:242-276): approach, descend, close,
        lift-move, lower, open."""
        a = np.asarray(action4_sim, np.float64) / self.sim_real_ratio
        start = np.array([a[0], a[1], self.push_height])
        end = np.array([a[2], a[3], self.push_height])
        orn = [180.0, 0.0, 0.0]
        hi = self.approach_height
        self.robot.open_gripper()
        for wp in (np.r_[start[:2], self.push_height + hi], start):
            self.robot.move_to_pose([*self._table_to_base_mm(wp), *orn], wait=True)
        self.robot.close_gripper()
        for wp in (np.r_[start[:2], self.push_height + hi],
                   np.r_[end[:2], self.push_height + hi], end):
            self.robot.move_to_pose([*self._table_to_base_mm(wp), *orn], wait=True)
        self.robot.open_gripper()
        self.robot.move_to_pose(
            [*self._table_to_base_mm(np.r_[end[:2], self.push_height + hi]), *orn],
            wait=True)
        return True
