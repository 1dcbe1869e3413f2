"""Port parity: perception (planning/perception.py) and the 2-D box side
task (sim/box2d.py) against the JAX package on the CPU.

Both modules are host numpy in both packages, so every array is held
equal: back-projection, the segmenter, voxel downsampling, outlier
removal (on a cloud past the 4,000-point cap too), the fused tabletop
cloud and the graph state on the same frames and RandomState (with and
without the height filter), the captured goal's .npy, and the box's poses
and episodes bit for bit. The round trip through the port's renderer is
held as tests/test_perception.py holds JAX's: 90% of the recovered points
within 0.2 of a particle.
"""

import numpy as np
import pytest
import torch

from adaptigraph_tpu.planning import perception as jp
from adaptigraph_tpu.sim import box2d as jb
from adaptigraph_torch.engine.state import SHAPE_PLANE, make_shapes
from adaptigraph_torch.planning import perception as tp
from adaptigraph_torch.sim import box2d as tb
from adaptigraph_torch.sim.cameras import CameraRig, view_matrix
from adaptigraph_torch.sim.env import _fwd_from_angle
from adaptigraph_torch.sim.render import render_frame


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(a, b)


def _render_cloud(points, size=128):
    """tests/test_perception.py's scene through the port's renderer: the
    cloud above a floor plane, camera view 1. Returns (frame, intr, extr)."""
    rig = CameraRig(size, size)
    pos, ang = rig.single_view(1)
    shapes = make_shapes([SHAPE_PLANE], [[0, 0, 0]], [[0, 0, 0]],
                         [[0, 0, 0, 1]], m_max=2, device="cpu")
    intr = rig.intrinsics()
    img = render_frame(torch.as_tensor(points),
                       torch.full((len(points), 3), 0.8),
                       torch.ones(len(points), dtype=torch.bool), shapes,
                       torch.tensor(pos, dtype=torch.float32),
                       torch.as_tensor(_fwd_from_angle(ang)),
                       torch.as_tensor(intr), width=size, height=size,
                       point_radius=0.1)
    return img.numpy(), intr, view_matrix(pos, ang)


@pytest.fixture(scope="module")
def scene():
    """A 200-point slab above the table (tests/test_perception.py's state
    extraction case) rendered by the port from the 4 cameras at 96 x 96."""
    rng = np.random.RandomState(3)
    pts = (rng.rand(200, 3) * np.array([1.5, 0.1, 1.5])
           + np.array([-0.7, 0.9, -0.7])).astype(np.float32)
    rig = CameraRig(96, 96)
    cam_pos, cam_ang, intrs, extrs = rig.multiview()
    shapes = make_shapes([SHAPE_PLANE], [[0, 0, 0]], [[0, 0, 0]],
                         [[0, 0, 0, 1]], m_max=2, device="cpu")
    frames = np.stack([render_frame(
        torch.as_tensor(pts), torch.full((200, 3), 0.8),
        torch.ones(200, dtype=torch.bool), shapes,
        torch.tensor(p, dtype=torch.float32),
        torch.as_tensor(_fwd_from_angle(a)), torch.as_tensor(rig.intrinsics()),
        width=96, height=96, point_radius=0.1).numpy()
        for p, a in zip(cam_pos, cam_ang)])
    return dict(pts=pts, colors=frames[..., :3], depths=frames[..., 4],
                intrs=intrs, extrs=extrs)


def test_round_trip_through_the_port_renderer():
    pts = np.array([[0.0, 1.0, 0.0], [0.5, 1.1, 0.3], [-0.4, 0.9, -0.2]],
                   np.float32)
    img, intr, extr = _render_cloud(pts)
    depth = img[..., 4]
    mask = tp.depth_mask_segmenter(img[..., :3], depth, 0.5, intr, extr)
    assert mask.sum() > 0
    _equal(mask, jp.depth_mask_segmenter(img[..., :3], depth, 0.5, intr,
                                         extr))
    cloud = tp.depth_to_points(depth, intr, extr, mask=mask)
    _equal(cloud, jp.depth_to_points(depth, intr, extr, mask=mask))
    d = np.linalg.norm(cloud[:, None] - pts[None], axis=-1).min(1)
    assert len(cloud) > 0 and np.quantile(d, 0.9) < 0.2
    assert (cloud[:, 1] > 0.5).all()  # the floor is segmented away


def test_depth_to_points_on_random_depths():
    rng = np.random.RandomState(0)
    depth = rng.uniform(0, 5, (24, 32)).astype(np.float32)
    depth[rng.rand(24, 32) < 0.2] = 0.0
    mask = rng.rand(24, 32) < 0.7
    intr = np.array([30.0, 28.0, 16.5, 11.5], np.float32)
    extr = view_matrix(np.array([1.0, 3.0, 2.0], np.float32),
                       np.array([0.3, -0.9, 0.0], np.float32))
    for m in (None, mask):
        _equal(tp.depth_to_points(depth, intr, extr, mask=m),
               jp.depth_to_points(depth, intr, extr, mask=m))
    _equal(tp.depth_mask_segmenter(None, depth, 0.5, intr, extr),
           jp.depth_mask_segmenter(None, depth, 0.5, intr, extr))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_voxel_downsample_and_outliers(dtype):
    rng = np.random.RandomState(1)
    pts = np.concatenate([rng.randn(300, 3) * 0.1,
                          rng.uniform(-3, 3, (8, 3))]).astype(dtype)
    for voxel in (0.02, 0.1):
        _equal(tp.voxel_downsample(pts, voxel), jp.voxel_downsample(pts, voxel))
    _equal(tp.voxel_downsample(pts[:0], 0.1), jp.voxel_downsample(pts[:0], 0.1))
    for k, ratio, iters in ((20, 2.0, 2), (5, 1.0, 3), (400, 2.0, 2)):
        out = tp.remove_statistical_outliers(pts, k, ratio, iters)
        _equal(out, jp.remove_statistical_outliers(pts, k, ratio, iters))
    assert len(tp.remove_statistical_outliers(pts)) < len(pts)
    _equal(tp.real_points_to_sim(pts, 10), jp.real_points_to_sim(pts, 10))


def test_tabletop_points_past_the_outlier_cap():
    """A cloud of more than 4,000 voxels: the RandomState(0) subset, then
    the outlier pass and the height filter, equal to JAX's."""
    rng = np.random.RandomState(2)
    depth = rng.uniform(2.0, 9.0, (1, 80, 80)).astype(np.float32)
    colors = np.zeros((1, 80, 80, 3), np.float32)
    intr = np.array([[40.0, 40.0, 40.0, 40.0]], np.float32)
    extr = view_matrix(np.array([0.0, 6.0, 0.0], np.float32),
                       np.array([0.0, -1.2, 0.0], np.float32))[None]
    task = {"fps_radius": 0.3, "max_nobj": 50, "k_filter": 0.8}

    def keep_all(c, d, th, k, e):
        return d > 0

    out = [mod.PerceptionModule(task, segmenter=keep_all).get_tabletop_points(
        colors, depth, intr, extr) for mod in (tp, jp)]
    n_vox = len(tp.voxel_downsample(tp.depth_to_points(depth[0], intr[0],
                                                       extr[0]), 0.02))
    assert n_vox > tp.OUTLIER_CAP
    assert 100 < len(out[0]) < tp.OUTLIER_CAP
    _equal(*out)


@pytest.mark.parametrize("k_filter", [1.0, 0.5])
def test_state_cur_equals_jax(scene, k_filter):
    task = {"fps_radius": 0.2, "max_nobj": 12, "k_filter": k_filter}
    args = (scene["colors"], scene["depths"], scene["intrs"], scene["extrs"])
    (st, ct), (sj, cj) = (mod.PerceptionModule(task, voxel=0.05).get_state_cur(
        *args, rng=np.random.RandomState(0)) for mod in (tp, jp))
    _equal(ct, cj)
    _equal(st, sj)
    assert len(st) == 12  # capped at max_nobj by FPS
    # the radius stage alone (no cap) picks the same indices too
    wide = dict(task, max_nobj=1000)
    (st, _), (sj, _) = (mod.PerceptionModule(wide, voxel=0.05).get_state_cur(
        *args, rng=np.random.RandomState(4)) for mod in (tp, jp))
    _equal(st, sj)
    assert 12 < len(st) < len(ct)
    d = np.linalg.norm(st[:, None] - scene["pts"][None], axis=-1).min(1)
    assert np.quantile(d, 0.9) < 0.3


def test_empty_frames_give_an_empty_state():
    task = {"fps_radius": 0.2, "max_nobj": 12}
    zeros = (np.zeros((2, 8, 8, 3)), np.zeros((2, 8, 8)),
             np.ones((2, 4)), np.tile(np.eye(4), (2, 1, 1)))
    st, cloud = tp.PerceptionModule(task).get_state_cur(*zeros)
    assert st.shape == (0, 3) and cloud.shape == (0, 3)
    _equal(st, jp.PerceptionModule(task).get_state_cur(*zeros)[0])


def test_capture_goal_npy_equal(scene, tmp_path):
    class Frames:
        cam_intr, cam_extr = scene["intrs"], scene["extrs"]

        def get_obs(self):
            return scene["colors"], scene["depths"]

    task = {"fps_radius": 0.2, "max_nobj": 12, "k_filter": 0.5}
    paths = [str(tmp_path / d / "goal.npy") for d in ("port", "jax")]
    pts = [mod.capture_goal(Frames(), mod.PerceptionModule(task), p)
           for mod, p in zip((tp, jp), paths)]
    _equal(*pts)
    saved = [np.load(p) for p in paths]
    _equal(*saved)
    _equal(saved[0], pts[0])
    assert len(saved[0]) > 20


# ---------------------------------------------------------------- box2d


def _pushes(mod, start, step, box=(1.0, 0.6), n=40):
    sim = mod.BoxSim(box)
    p = np.asarray(start, np.float64)
    hits = []
    for _ in range(n):
        p = p + step
        hits.append(sim.push(p, step))
    return sim, hits


@pytest.mark.parametrize("start", [[-0.6, 0.0], [-0.6, 0.25], [0.1, -0.5]])
def test_box_pushes_bit_for_bit(start):
    """tests/test_real_world.py's centred and offset pushes (and one from
    below): poses, contacts, corners and the SDF equal."""
    step = np.array([0.02, 0.0]) if start[1] > -0.5 else np.array([0.0, 0.02])
    (st, ht), (sj, hj) = (_pushes(m, start, step) for m in (tb, jb))
    assert ht == hj and any(ht)
    _equal(st.pose, sj.pose)
    _equal(st.corners(), sj.corners())
    q = np.array([0.3, 0.1])
    assert st.sdf(q) == sj.sdf(q)
    if start == [-0.6, 0.0]:
        assert st.pose[0] > 0.1 and abs(st.pose[2]) < 0.2
    if start == [-0.6, 0.25]:
        assert abs(st.pose[2]) > 0.05


def test_box_episodes_bit_for_bit(tmp_path):
    for seed in (0, 7):
        et, ej = (m.gen_box_episode(np.random.RandomState(seed), render=True)
                  for m in (tb, jb))
        assert sorted(et) == sorted(ej)
        for k in et:
            _equal(et[k], ej[k])
    n = [m.gen_box_data(str(tmp_path / d), n_episodes=2, seed=3)
         for m, d in ((tb, "port"), (jb, "jax"))]
    assert n == [2, 2]
    for i in range(2):
        dt, dj = (np.load(tmp_path / d / f"box_{i:04}.npz")
                  for d in ("port", "jax"))
        assert sorted(dt.files) == sorted(dj.files)
        assert dt["states"].shape == (5, 3)
        for k in dt.files:
            _equal(dt[k], dj[k])
