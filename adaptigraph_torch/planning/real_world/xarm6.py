"""xArm6 hardware driver wrapper: the port of
adaptigraph_tpu/planning/real_world/xarm6.py.

As the reference's src/planning/real_world/xarm6.py:8-161: a thin
wrapper over the xArm python SDK — connect, linear move_to_pose, joint control, gripper
open/close, error/warn callbacks, liveness. Import-gated so the framework
works without the SDK; `FakeXarm` is the test double: it keeps the
commanded pose and joints and always succeeds.
"""

from __future__ import annotations

import numpy as np


class XarmController:
    DEFAULT_SPEED = 50  # mm/s

    def __init__(self, ip: str = "192.168.1.209"):
        from xarm.wrapper import XArmAPI  # noqa: hardware-only dependency

        self.arm = XArmAPI(ip)
        self.arm.motion_enable(enable=True)
        self.arm.set_mode(0)
        self.arm.set_state(0)
        self.arm.register_error_warn_changed_callback(self._on_error)
        self._alive = True

    def _on_error(self, data):
        if data and data.get("error_code", 0) != 0:
            print(f"[xarm6] error {data}")
            self._alive = False

    @property
    def is_alive(self) -> bool:
        return self._alive and self.arm.connected

    def move_to_pose(self, pose, wait=True, speed=None):
        """pose: [x, y, z, roll, pitch, yaw] in mm/deg (SDK convention)."""
        code = self.arm.set_position(*pose, speed=speed or self.DEFAULT_SPEED,
                                     wait=wait)
        return code == 0

    def get_pose(self):
        code, pose = self.arm.get_position()
        return np.asarray(pose) if code == 0 else None

    def set_joints(self, joints_deg, wait=True, speed=None):
        code = self.arm.set_servo_angle(angle=list(joints_deg), wait=wait,
                                        speed=speed or 20)
        return code == 0

    def get_joints(self):
        code, joints = self.arm.get_servo_angle()
        return np.asarray(joints) if code == 0 else None

    def open_gripper(self, pos: int = 800):
        self.arm.set_gripper_enable(True)
        return self.arm.set_gripper_position(pos, wait=True) == 0

    def close_gripper(self, pos: int = 0):
        self.arm.set_gripper_enable(True)
        return self.arm.set_gripper_position(pos, wait=True) == 0

    def reset(self):
        self.arm.reset(wait=True)

    def close(self):
        self.arm.disconnect()


class FakeXarm:
    """Kinematic test double: tracks the commanded pose, always succeeds."""

    def __init__(self, ip: str = ""):
        self.pose = np.array([300.0, 0.0, 300.0, 180.0, 0.0, 0.0])
        self.joints = np.zeros(6)
        self.gripper = 800
        self._alive = True

    @property
    def is_alive(self):
        return self._alive

    def move_to_pose(self, pose, wait=True, speed=None):
        self.pose = np.asarray(pose, np.float64)
        return True

    def get_pose(self):
        return self.pose.copy()

    def set_joints(self, joints_deg, wait=True, speed=None):
        self.joints = np.asarray(joints_deg, np.float64)
        return True

    def get_joints(self):
        return self.joints.copy()

    def open_gripper(self, pos: int = 800):
        self.gripper = pos
        return True

    def close_gripper(self, pos: int = 0):
        self.gripper = pos
        return True

    def reset(self):
        self.pose = np.array([300.0, 0.0, 300.0, 180.0, 0.0, 0.0])

    def close(self):
        self._alive = False
