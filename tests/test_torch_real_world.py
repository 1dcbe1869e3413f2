"""Port parity: the real-robot layer (planning/real_world/: timestamps,
depth filters, cameras, the xArm6 double, RealEnv and its hand-eye
solver), plan.make_env's real environment, and planning/segmentation.py,
against the JAX package on the CPU.

Everything here is host numpy, so the same inputs give the same bits:
timestamps, depth filters, the hand-eye solve and the segmenter's masks
are held equal. The camera processes and RealEnv run with their doubles
(SimCameraBackend, FakeXarm): shapes, dtypes and alignment, and the
double arm's call log equal to JAX's for the same pushes.
"""

import os

import numpy as np
import pytest

from adaptigraph_tpu.planning import segmentation as jseg
from adaptigraph_tpu.planning.real_world import cameras as jcam
from adaptigraph_tpu.planning.real_world import depth_filters as jdf
from adaptigraph_tpu.planning.real_world import real_env as jre
from adaptigraph_tpu.planning.real_world import timestamp as jts
from adaptigraph_tpu.planning.real_world import xarm6 as jx
from adaptigraph_torch.planning import plan as tplan
from adaptigraph_torch.planning import segmentation as tseg
from adaptigraph_torch.planning.real_world import cameras as tcam
from adaptigraph_torch.planning.real_world import depth_filters as tdf
from adaptigraph_torch.planning.real_world import real_env as tre
from adaptigraph_torch.planning.real_world import timestamp as tts
from adaptigraph_torch.planning.real_world import xarm6 as tx


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------- timestamps ----------

def _stream(seed, n=40, dt=0.1, drop=0.25):
    rng = np.random.RandomState(seed)
    ts = 1.0 + np.arange(n) * dt + rng.uniform(-0.03, 0.03, n)
    keep = rng.rand(n) > drop  # dropped frames
    return np.sort(ts[keep])


def test_timestamp_alignment_matches_jax():
    for seed in range(3):
        ts = _stream(seed)
        for start, next_tick in ((1.0, 0), (1.05, 3), (0.7, None)):
            for allow in (False, True):
                _equal(tts.tick_fill_indices(ts, start, 0.1, next_tick=next_tick,
                                             allow_negative=allow),
                       jts.tick_fill_indices(ts, start, 0.1, next_tick=next_tick,
                                             allow_negative=allow))
        ticks = list(range(2, 30))
        _equal(tts.align_to_ticks(ts, ticks, 1.0, 0.1),
               jts.align_to_ticks(ts, ticks, 1.0, 0.1))
        streams = {"cam_0": (ts, np.arange(len(ts))),
                   "cam_1": (_stream(seed + 10), None),
                   "robot": (_stream(seed + 20, drop=0.0), None)}
        streams = {k: (t, np.arange(len(t)) if i is None else i)
                   for k, (t, i) in streams.items()}
        _equal(tts.align_obs(streams, 0.1), jts.align_obs(streams, 0.1))


def test_accumulators_match_jax():
    rng = np.random.RandomState(0)
    accs = [(m.ObsAccumulator(1.0, 0.1), m.ActionAccumulator(1.0, 0.1),
             m.TimestampAccumulator(1.0, 0.1)) for m in (tts, jts)]
    t = 1.0
    for _ in range(6):
        n = rng.randint(1, 6)
        ts = t + np.cumsum(rng.uniform(0.02, 0.25, n))
        t = ts[-1]
        obs = {"img": rng.rand(n, 2, 3).astype(np.float32),
               "q": rng.randint(0, 9, (n, 6))}
        act = rng.rand(n, 4)
        back = ts - rng.uniform(0.0, 0.3)  # re-planning overwrites
        for o, a, s in accs:
            o.put(obs, ts)
            a.put(act, back)
            s.put(ts)
    (to, ta, tsa), (jo, ja, jsa) = accs
    assert len(to) == len(jo) > 0
    _equal(to.data, jo.data)
    _equal(to.actual_timestamps, jo.actual_timestamps)
    _equal(to.timestamps, jo.timestamps)
    _equal(ta.actions, ja.actions)
    _equal(ta.actual_timestamps, ja.actual_timestamps)
    _equal(tsa.get(), jsa.get())


# ---------- depth filters ----------

def _depth_frames(n=3, h=24, w=32):
    rng = np.random.RandomState(0)
    base = 800 + 200 * np.linspace(0, 1, w)[None, :] + np.zeros((h, 1))
    base[8:16, 10:20] = 500  # an object in front: an edge to preserve
    out = []
    for _ in range(n):
        d = base + rng.normal(0, 3, (h, w))
        d[rng.rand(h, w) < 0.05] = 0  # holes
        out.append(d.astype(np.uint16))
    return out


def test_depth_filters_bit_for_bit():
    frames = _depth_frames()
    d0 = frames[0]
    _equal(tdf._to_disparity(d0), jdf._to_disparity(d0))
    disp = jdf._to_disparity(d0)
    for mag, fill in ((1, 0), (5, 1), (2, 2)):
        _equal(tdf.spatial_filter(disp, mag, 0.6, 1.5, fill),
               jdf.spatial_filter(disp, mag, 0.6, 1.5, fill))
    tt, jt = tdf.TemporalFilter(0.75, 1.0), jdf.TemporalFilter(0.75, 1.0)
    tp, jp = tdf.DepthProcessor(), jdf.DepthProcessor()
    for d in frames:
        x = jdf._to_disparity(d)
        _equal(tt(x), jt(x))
        a, b = tp(d), jp(d)
        _equal(a, b)
        assert a.dtype == np.uint16
    # the edge survives and the holes are filled
    assert abs(int(a[12, 15]) - 500) < 20 and (a > 0).mean() > (d > 0).mean()


# ---------- cameras and RealEnv with their doubles ----------

def test_sim_camera_rig_shapes():
    backends = {f"cam_{i}": tcam.SimCameraBackend((32, 32)) for i in range(2)}
    rig = tcam.MultiCamera(backends, (32, 32), process_depth=True)
    assert rig.start(wait_ready=20.0)
    try:
        frames = rig.get_obs(max_skew=0.1)
        assert sorted(frames) == ["cam_0", "cam_1"]
        ts = [f["timestamp"][0] for f in frames.values()]
        assert max(ts) - min(ts) <= 0.1
        for f in frames.values():
            assert f["color"].shape == (32, 32, 3) and f["color"].dtype == np.uint8
            assert f["depth"].shape == (32, 32) and f["depth"].dtype == np.uint16
            assert f["seq"][0] >= 0
    finally:
        rig.stop()
    assert backends["cam_0"].get_intrinsics().tolist() == \
        jcam.SimCameraBackend((32, 32)).get_intrinsics().tolist()


@pytest.mark.parametrize("mod", [tcam, jcam], ids=["port", "jax"])
def test_sim_camera_double_serves_black_frames_in_both_packages(mod):
    """Kept for parity: the double's open() runs in the capture process and
    resets its frame to black there, and feed() in the parent never reaches
    that process, so a fed frame is never served (cameras.py:110-115)."""
    backend = mod.SimCameraBackend((16, 16))
    fed = (np.full((16, 16, 3), 200, np.uint8), np.full((16, 16), 900, np.uint16))
    backend.feed(*fed)
    name = f"black_{os.getpid()}"  # JAX's ring names carry no pid
    rig = mod.MultiCamera({name: backend}, (16, 16))
    assert rig.start(wait_ready=20.0)
    try:
        backend.feed(*fed)
        frames = rig.get_obs()
        f = frames[name]
        assert not f["color"].any() and not f["depth"].any()
    finally:
        rig.stop()


def _logged(cls, log):
    class Logged(cls):
        def move_to_pose(self, pose, wait=True, speed=None):
            log.append(("move", [float(x) for x in pose]))
            return super().move_to_pose(pose, wait, speed)

        def open_gripper(self, pos=800):
            log.append(("open", pos))
            return super().open_gripper(pos)

        def close_gripper(self, pos=0):
            log.append(("close", pos))
            return super().close_gripper(pos)

    return Logged


def test_real_env_double_push_matches_jax(monkeypatch, tmp_path):
    """The push and the grasp primitives through FakeXarm: the double's
    call log equal to JAX's, the pose after the push lifted above its end
    point, the frames' shapes and dtypes."""
    logs = {}
    for name, mod, xmod in (("port", tre, tx), ("jax", jre, jx)):
        log = logs[name] = []
        monkeypatch.setattr(xmod, "FakeXarm", _logged(xmod.FakeXarm, log))
        # JAX's double gets no cameras (no serials): its rings' names carry
        # no pid, and its own tests may hold them
        env = mod.RealEnv(task_config={"sim_real_ratio": 10,
                                       "clipping_height": -0.06},
                          use_robot=False,
                          use_real_cameras=name == "jax", camera_serials=[],
                          resolution=(24, 24), calib_dir=str(tmp_path / name))
        if name == "port":
            env.T_table_base = np.array([[0.0, -1, 0, 0.3], [1, 0, 0, -0.1],
                                         [0, 0, 1, 0.02], [0, 0, 0, 1]])
            env.start(wait_ready=20.0)
            try:
                colors, depths = env.get_obs()
                assert colors.shape == (4, 24, 24, 3) and colors.dtype == np.uint8
                assert depths.shape == (4, 24, 24) and depths.dtype == np.float32
                ok = env.step(np.array([-1.0, 0.5, 0.5, 0.5]))
                pose = env.robot.get_pose()
                grasp = env.step_gripper(np.array([-1.0, 0.5, 0.8, -0.2]))
            finally:
                env.stop()
        else:  # JAX's double, without its camera processes
            env.T_table_base = logs_tb
            ok = env.step(np.array([-1.0, 0.5, 0.5, 0.5]))
            jpose = env.robot.get_pose()
            grasp = env.step_gripper(np.array([-1.0, 0.5, 0.8, -0.2]))
        assert ok and grasp
        logs_tb = env.T_table_base
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 13
    np.testing.assert_array_equal(pose, jpose)
    assert [c for c, _ in logs["port"][4:]] == [
        "open", "move", "move", "close", "move", "move", "move", "open",
        "move"]


def test_real_env_calibration_load(tmp_path):
    import pickle

    intr = np.arange(16, dtype=np.float32).reshape(4, 4)
    extr = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    tb = np.diag([1.0, -1.0, -1.0, 1.0])
    with open(tmp_path / "calibration.pkl", "wb") as f:
        pickle.dump({"intr": intr, "extr": extr, "T_table_base": np.eye(4)}, f)
    with open(tmp_path / "calibration_handeye.pkl", "wb") as f:
        pickle.dump({"T_table_base": tb}, f)
    envs = [m.RealEnv(use_robot=False, use_real_cameras=True,
                      camera_serials=[], resolution=(8, 8),
                      calib_dir=str(tmp_path)) for m in (tre, jre)]
    for e in envs:
        e._load_calibration()
    _equal(envs[0].cam_intr, envs[1].cam_intr)
    _equal(envs[0].cam_extr, envs[1].cam_extr)
    _equal(envs[0].T_table_base, tb)
    _equal(envs[0]._table_to_base_mm([0.1, 0.2, -0.5]),
           envs[1]._table_to_base_mm([0.1, 0.2, -0.5]))


def _rotation(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


def test_handeye_solver_matches_jax_and_recovers_the_transforms():
    rng = np.random.RandomState(0)
    r_z, t_z = _rotation(rng), rng.randn(3)  # base -> world
    r_y, t_y = _rotation(rng), rng.randn(3) * 0.1  # gripper -> cam
    r_b2c, t_b2c, r_g2b, t_g2b = [], [], [], []
    for _ in range(8):
        r_g, t_g = _rotation(rng), rng.randn(3)  # gripper -> base
        r_bg, t_bg = r_g.T, -r_g.T @ t_g  # base -> gripper
        # A Z = Y B: A (world -> cam) = Y B Z^-1
        r_a = r_y @ r_bg @ r_z.T
        t_a = r_y @ (r_bg @ (-r_z.T @ t_z) + t_bg) + t_y
        r_b2c.append(r_a), t_b2c.append(t_a)
        r_g2b.append(r_g), t_g2b.append(t_g)
    out_t = tre.solve_robot_world_handeye(r_b2c, t_b2c, r_g2b, t_g2b)
    out_j = jre.solve_robot_world_handeye(r_b2c, t_b2c, r_g2b, t_g2b)
    _equal(out_t, out_j)
    t_table_base, t_gripper_cam = out_t
    base_world = np.linalg.inv(t_table_base)
    np.testing.assert_allclose(base_world[:3, :3], r_z, atol=1e-9)
    np.testing.assert_allclose(base_world[:3, 3], t_z, atol=1e-9)
    np.testing.assert_allclose(t_gripper_cam[:3, :3], r_y, atol=1e-9)
    for r in (0.0, 30.0, -75.5):
        _equal(tre.rpy_to_rotation(r, 10.0, r / 2),
               jre.rpy_to_rotation(r, 10.0, r / 2))


def test_make_env_real_builds_a_real_env(monkeypatch, tmp_path):
    tc = {"material": "rope", "sim_real_ratio": 10}
    env = tplan.make_env(tc, "real", use_robot=False, use_real_cameras=False,
                         resolution=(8, 8), calib_dir=str(tmp_path))
    assert isinstance(env, tre.RealEnv) and env.units == "real"
    assert isinstance(env.robot, tx.FakeXarm)
    assert sorted(env.cameras.cams) == [f"cam_{i}" for i in range(4)]
    for cam in env.cameras.cams.values():
        cam.ring.close()
    # the hardware driver needs the xArm SDK, which is not installed
    with pytest.raises(ImportError, match="xarm"):
        tplan.make_env(tc, "real", use_real_cameras=False,
                       calib_dir=str(tmp_path))


# ---------- segmentation ----------

class _Detector:
    def __init__(self, boxes, scores, phrases):
        self.out = (np.asarray(boxes, np.float32), np.asarray(scores),
                    list(phrases))

    def __call__(self, rgb):
        return self.out


class _Sam:
    def set_image(self, rgb):
        self.shape = rgb.shape[:2]

    def predict(self, box):
        m = np.zeros(self.shape, bool)
        x0, y0, x1, y1 = [int(v) for v in box]
        m[y0:y1, x0:x1] = True
        return m


def test_segmenter_over_injected_callables_matches_jax():
    rng = np.random.RandomState(0)
    color = rng.rand(40, 48, 3).astype(np.float32)
    depth = rng.uniform(0, 1, (40, 48)).astype(np.float32)
    depth[:4] = 0
    cases = [
        ([[2, 2, 30, 20], [3, 2, 30, 20], [0, 25, 48, 40], [35, 5, 45, 15]],
         [0.9, 0.8, 0.95, 0.2], ["rope", "rope", "table", "rope"]),
        ([[5, 5, 10, 10]], [0.1], ["rope"]),
        ([[5, 5, 20, 20], [10, 10, 40, 30]], [0.5, 0.6], ["object", "object"]),
    ]
    for boxes, scores, phrases in cases:
        outs = [m.GroundingSAMSegmenter(_Detector(boxes, scores, phrases),
                                        _Sam(), iou_thresh=0.8)(
            color, depth, 0.0, None, None) for m in (tseg, jseg)]
        _equal(outs[0], outs[1])
    masks = [np.zeros((8, 8), bool) for _ in range(3)]
    masks[0][:4] = masks[1][:4] = masks[2][4:] = True
    masks[1][4, 0] = True
    assert tseg.mask_iou(masks[0], masks[1]) == jseg.mask_iou(masks[0], masks[1])
    for thresh in (0.5, 0.9, 0.99):
        assert tseg.iou_dedupe(masks, [0.3, 0.9, 0.5], thresh) == \
            jseg.iou_dedupe(masks, [0.3, 0.9, 0.5], thresh)


def test_from_checkpoints_names_the_missing_weights(tmp_path):
    with pytest.raises(FileNotFoundError, match="GroundingDINO") as e:
        tseg.GroundingSAMSegmenter.from_checkpoints(
            str(tmp_path / "gdino.py"), str(tmp_path / "gdino.pth"),
            str(tmp_path / "sam.pth"))
    assert "SAM" in str(e.value) and "gdino.py" in str(e.value)
    for f in ("gdino.py", "gdino.pth", "sam.pth"):
        (tmp_path / f).write_text("")
    with pytest.raises(ImportError, match="groundingdino and segment_anything"):
        tseg.GroundingSAMSegmenter.from_checkpoints(
            str(tmp_path / "gdino.py"), str(tmp_path / "gdino.pth"),
            str(tmp_path / "sam.pth"))


# ---------- hardware and drawing packages stay lazy ----------

_ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
_LAZY = ("cv2", "pyrealsense2", "xarm", "PIL", "groundingdino",
         "segment_anything", "matplotlib")


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(_ROOT)) for p in
                   list((_ROOT / "adaptigraph_torch").rglob("*.py"))
                   + [_ROOT / "chip_smoke.py"]))
def test_port_imports_hardware_and_drawing_packages_lazily(path):
    """cv2, pyrealsense2, xarm, PIL, groundingdino, segment_anything and
    matplotlib are imported only inside the functions that need them: no
    module of the port (nor chip_smoke.py) imports one when it is
    imported, and none of them is on the card's machine."""
    import ast

    tree = ast.parse((_ROOT / path).read_text(), filename=path)
    top = list(tree.body)
    while top:
        node = top.pop()
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            top.extend(ast.iter_child_nodes(node))
            continue
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _LAZY, (path, name)
