"""Camera capture processes: producer processes + shared-memory transport;
the port of adaptigraph_tpu/planning/real_world/cameras.py.

As the reference's src/planning/real_world/camera/ (SingleRealsense
single_realsense.py:22-240, MultiRealsense multi_realsense.py:10-170): each
camera runs in its own process publishing timestamped frames into a
shared-memory ring buffer; the consumer fetches the latest aligned bundle.

The hardware backend is pluggable:
  * `RealsenseBackend` wraps pyrealsense2 when the SDK is present
    (exposure / white-balance control, depth scale, intrinsics);
  * `SimCameraBackend` renders frames from a SimEnv snapshot — the hardware
    double used by tests and the sim-in-the-loop planner.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time

import numpy as np

from adaptigraph_torch.planning.real_world.shared_memory import (
    SharedMemoryRingBuffer)


def _frame_specs(h, w):
    return {
        "color": ((h, w, 3), np.uint8),
        "depth": ((h, w), np.uint16),  # mm
        "timestamp": ((1,), np.float64),
        "seq": ((1,), np.int64),
    }


class CameraBackend:
    """Minimal capture interface."""

    def open(self):
        raise NotImplementedError

    def read(self):
        """-> (color uint8 (H,W,3), depth_mm uint16 (H,W), timestamp)"""
        raise NotImplementedError

    def close(self):
        pass

    def get_intrinsics(self):
        raise NotImplementedError

    def get_depth_scale(self):
        return 0.001


class RealsenseBackend(CameraBackend):
    """pyrealsense2 capture (single_realsense.py:22-140). Import-gated."""

    def __init__(self, serial, resolution=(720, 720), fps=30,
                 exposure=None, white_balance=None):
        self.serial = serial
        self.resolution = resolution
        self.fps = fps
        self.exposure = exposure
        self.white_balance = white_balance

    def open(self):
        import pyrealsense2 as rs  # noqa: hardware-only dependency

        self.rs = rs
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_device(self.serial)
        h, w = self.resolution
        cfg.enable_stream(rs.stream.color, w, h, rs.format.bgr8, self.fps)
        cfg.enable_stream(rs.stream.depth, w, h, rs.format.z16, self.fps)
        self.profile = self.pipeline.start(cfg)
        sensor = self.profile.get_device().first_color_sensor()
        if self.exposure is not None:
            sensor.set_option(rs.option.enable_auto_exposure, 0)
            sensor.set_option(rs.option.exposure, self.exposure)
        if self.white_balance is not None:
            sensor.set_option(rs.option.enable_auto_white_balance, 0)
            sensor.set_option(rs.option.white_balance, self.white_balance)
        self.align = rs.align(rs.stream.color)

    def read(self):
        frames = self.align.process(self.pipeline.wait_for_frames())
        color = np.asanyarray(frames.get_color_frame().get_data())[..., ::-1]
        depth = np.asanyarray(frames.get_depth_frame().get_data())
        return color.astype(np.uint8), depth.astype(np.uint16), time.time()

    def get_intrinsics(self):
        v = self.profile.get_stream(self.rs.stream.color) \
            .as_video_stream_profile().get_intrinsics()
        return np.array([v.fx, v.fy, v.ppx, v.ppy], np.float32)

    def get_depth_scale(self):
        return self.profile.get_device().first_depth_sensor().get_depth_scale()

    def close(self):
        self.pipeline.stop()


class SimCameraBackend(CameraBackend):
    """Hardware double: serves frames pushed in by the sim loop."""

    def __init__(self, resolution=(720, 720)):
        self.resolution = resolution
        self._frame = None

    def open(self):
        h, w = self.resolution
        self._frame = (np.zeros((h, w, 3), np.uint8), np.zeros((h, w), np.uint16))

    def feed(self, color, depth_mm):
        self._frame = (color, depth_mm)

    def read(self):
        time.sleep(0.01)
        c, d = self._frame
        return c, d, time.time()

    def get_intrinsics(self):
        return np.array([869.12, 869.12, self.resolution[1] / 2,
                         self.resolution[0] / 2], np.float32)


def _capture_loop(backend, ring_name, h, w, stop_event, ready_event,
                  process_depth=False):
    backend.open()
    ring = SharedMemoryRingBuffer(ring_name, _frame_specs(h, w), capacity=16,
                                  create=False)
    ready_event.set()
    seq = 0
    processor = None
    if process_depth:
        from adaptigraph_torch.planning.real_world.depth_filters import \
            DepthProcessor

        # stateful per stream (temporal history), like the reference's
        # per-camera depth_process (single_realsense.py:213-231, :327)
        processor = DepthProcessor()
    try:
        while not stop_event.is_set():
            color, depth, ts = backend.read()
            if processor is not None:
                depth = processor(depth)
            ring.put({"color": color, "depth": depth,
                      "timestamp": np.array([ts]), "seq": np.array([seq])})
            seq += 1
    finally:
        ring.close(unlink=False)
        backend.close()


class SingleCamera:
    """One capture process + ring buffer (SingleRealsense equivalent)."""

    def __init__(self, backend: CameraBackend, name: str, resolution=(720, 720),
                 process_depth=False):
        self.backend = backend
        self.resolution = resolution
        self.process_depth = process_depth
        self.ring_name = f"agtorch_cam_{os.getpid()}_{name}"
        h, w = resolution
        self.ring = SharedMemoryRingBuffer(self.ring_name, _frame_specs(h, w),
                                           capacity=16, create=True)
        self.stop_event = mp.Event()
        self.ready_event = mp.Event()
        self.proc = None

    def start(self):
        h, w = self.resolution
        self.proc = mp.Process(target=_capture_loop,
                               args=(self.backend, self.ring_name, h, w,
                                     self.stop_event, self.ready_event,
                                     self.process_depth),
                               daemon=True)
        self.proc.start()

    @property
    def is_ready(self):
        return self.ready_event.is_set()

    def get_latest(self):
        return self.ring.get_latest()

    def stop(self):
        self.stop_event.set()
        if self.proc is not None:
            self.proc.join(timeout=2)
            if self.proc.is_alive():
                self.proc.terminate()
        self.ring.close()


class MultiCamera:
    """Fan-out over n cameras with timestamp-aligned reads
    (MultiRealsense + RealEnv.get_obs alignment, real_env.py:152-198)."""

    def __init__(self, backends: dict, resolution=(720, 720),
                 process_depth=False):
        self.cams = {name: SingleCamera(b, name, resolution,
                                        process_depth=process_depth)
                     for name, b in backends.items()}

    def start(self, wait_ready: float = 5.0):
        for c in self.cams.values():
            c.start()
        t0 = time.time()
        while time.time() - t0 < wait_ready:
            if all(c.is_ready for c in self.cams.values()):
                return True
            time.sleep(0.05)
        return all(c.is_ready for c in self.cams.values())

    def get_obs(self, max_skew: float = 0.1, timeout: float = 2.0):
        """Latest frame per camera, retrying until timestamps align within
        max_skew seconds."""
        t0 = time.time()
        while True:
            frames = {}
            ok = True
            for name, c in self.cams.items():
                f, seq = c.get_latest()
                if f is None:
                    ok = False
                    break
                frames[name] = f
            if ok:
                ts = [f["timestamp"][0] for f in frames.values()]
                if max(ts) - min(ts) <= max_skew:
                    return frames
            if time.time() - t0 > timeout:
                return frames if frames else None
            time.sleep(0.01)

    def stop(self):
        for c in self.cams.values():
            c.stop()
