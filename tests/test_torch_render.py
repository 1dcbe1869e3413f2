"""Port parity: the ray-cast renderer (sim/render.py) against the JAX
package's on the CPU.

Frames come from the JAX tests' scenes (a particle's depth, the floor, a
box occluding the floor, a capsule, a convex arm link, the cloth grid with
its mesh raster on and off, draped cloth shading) plus a z-buffer tie: two
fragments at one depth on one pixel, where JAX's ordered CPU scatter lets
the later fragment win and the port's scatter-max of fragment indices
must do the same. Tolerances:
- float frames (RGB, alpha, depth) within 1e-5 at every pixel off a
  depth discontinuity (render.silhouette_pixels: a 3 x 3 neighbourhood
  spanning more than 0.05). On a silhouette a grazing ray's quadratic or
  a splat's rounded pixel can fall either way under one ulp of different
  arithmetic (XLA contracts the ray sums into fused multiply-adds); those
  pixels are counted, and the count is held to at most _MAX_SILHOUETTE
  (measured: the capsule 6 of 9,216 pixels, every other scene 0);
- quantised frames (render_frames_store): uint8 colour and uint16 depth
  equal except for values off by one (the stores truncate, so an ulp
  near an integer flips one), counted and held to at most
  _MAX_OFF_BY_ONE of all values (measured: colour 9 of 49,152, depth 38
  of 16,384), and never more than one off a silhouette.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptigraph_tpu.engine import state as jstate
from adaptigraph_tpu.sim import render as jrender
from adaptigraph_tpu.sim import robot as jrobot
from adaptigraph_torch.engine import state as tstate
from adaptigraph_torch.sim import render as trender
from adaptigraph_torch.sim.cameras import CameraRig
from adaptigraph_torch.sim.env import _fwd_from_angle

_ATOL = 1e-5
_MAX_SILHOUETTE = 24
_MAX_OFF_BY_ONE = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(mod, kinds, sizes, poses, quats, **kw):
    if mod is jstate:
        return jstate.make_shapes(kinds, sizes, poses, quats, **kw)
    return tstate.make_shapes(kinds, sizes, poses, quats, device="cpu", **kw)


def _cam(px):
    rig = CameraRig(px, px)
    pos, ang = rig.single_view(1)
    intr = (rig.intrinsics() * (px / 720.0)).astype(np.float32)
    return pos.astype(np.float32), _fwd_from_angle(ang), intr


def _both(pos, colors, active, shape_args, cam, **kw):
    """(JAX frame, port frame) of one scene, numpy."""
    cam_pos, fwd, intr = cam
    shape_kw = shape_args.pop("kw", {})
    fj = jrender.render_frame(
        jnp.asarray(pos), jnp.asarray(colors), jnp.asarray(active),
        _shapes(jstate, **shape_args, **shape_kw), jnp.asarray(cam_pos),
        jnp.asarray(fwd), jnp.asarray(intr), **kw)
    ft = trender.render_frame(
        torch.as_tensor(pos), torch.as_tensor(colors),
        torch.as_tensor(active), _shapes(tstate, **shape_args, **shape_kw),
        torch.as_tensor(cam_pos), torch.as_tensor(fwd),
        torch.as_tensor(intr), **kw)
    return np.asarray(fj), ft.numpy()


def _hold(fj, ft):
    """Float frames within _ATOL off the silhouette; returns the count of
    silhouette pixels beyond it."""
    assert fj.shape == ft.shape and ft.dtype == np.float32
    off = np.abs(fj - ft).max(-1) > _ATOL
    sil = trender.silhouette_pixels(fj[..., 4])
    assert not (off & ~sil).any(), np.argwhere(off & ~sil)[:5]
    assert off.sum() <= _MAX_SILHOUETTE, off.sum()
    return int(off.sum())


def _plane(m_max=2):
    return dict(kinds=[2], sizes=[[0, 0, 0]], poses=[[0, 0, 0]],
                quats=[[0, 0, 0, 1]], kw=dict(m_max=m_max))


def _no_particles():
    return (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
            np.zeros(1, bool))


def test_particle_depth():
    fj, ft = _both(np.array([[0.0, 0.5, 0.0]], np.float32),
                   np.array([[1.0, 0.0, 0.0]], np.float32), np.array([True]),
                   _plane(), _cam(96), width=96, height=96, point_radius=0.3)
    _hold(fj, ft)
    red = (ft[..., 0] > 0.9) & (ft[..., 1] < 0.2)
    assert red.sum() > 0


def test_zbuffer_tie_takes_the_later_fragment():
    """Two particles at one position: every covered pixel holds fragments
    of both at equal depth. JAX's CPU scatter writes them in order, so the
    later particle's colour shows; the port must match."""
    pos = np.array([[0.0, 0.5, 0.0], [0.0, 0.5, 0.0]], np.float32)
    colors = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    fj, ft = _both(pos, colors, np.array([True, True]), _plane(), _cam(96),
                   width=96, height=96, point_radius=0.3)
    green = (fj[..., 1] > 0.9) & (fj[..., 0] < 0.1)
    assert green.sum() > 0 and not (fj[..., 0] > 0.9).any()
    np.testing.assert_array_equal(ft, fj)


def test_floor_and_box_occlusion():
    fj, ft = _both(*_no_particles(), _plane(), _cam(64), width=64, height=64)
    _hold(fj, ft)
    assert ft[40:, :, 4].min() > 0
    box = dict(kinds=[2, 0], sizes=[[0, 0, 0], [1.0, 1.0, 1.0]],
               poses=[[0, 0, 0], [0, 0, 0]], quats=[[0, 0, 0, 1]] * 2,
               kw=dict(m_max=2))
    fj, ft = _both(*_no_particles(), box, _cam(64), width=64, height=64)
    _hold(fj, ft)
    assert 0 < ft[32, 32, 4] < np.linalg.norm([6.0, 10.0, 6.0]) - 1.0


def test_capsule_and_padding_slot():
    cap = dict(kinds=[2, 1], sizes=[[0, 0, 0], [0.2, 0.6, 0]],
               poses=[[0, 0, 0], [0.3, 0.5, 0.1]],
               quats=[[0, 0, 0, 1], [0, 0.38, 0.1, 0.92]], kw=dict(m_max=3))
    fj, ft = _both(*_no_particles(), cap, _cam(96), width=96, height=96)
    _hold(fj, ft)
    assert (np.abs(ft[..., 4] - ft[95, 95, 4]) > 1.0).any()


def test_convex_arm_link():
    planes = jrobot.load_arm_assets(scale=10.0)["planes"][1]
    link = dict(kinds=[3], sizes=[np.zeros(3)], poses=[[0.0, 1.0, 0.0]],
                quats=[[0, 0, 0, 1.0]], kw=dict(planes=[planes]))
    cam = (np.array([0.0, 1.0, 6.0], np.float32),
           np.array([0.0, 0.0, -1.0], np.float32),
           np.array([120.0, 120.0, 48.0, 48.0], np.float32))
    fj, ft = _both(*_no_particles(), link, cam, width=96, height=96)
    _hold(fj, ft)
    depth = ft[..., 4]
    assert ((depth > 0) & (depth < 7.0)).sum() > 20


def _flat_grid(dimx, dimz, spacing, y=0.5):
    xs, zs = np.arange(dimx) * spacing, np.arange(dimz) * spacing
    zz, xx = np.meshgrid(zs, xs, indexing="ij")
    pos = np.stack([xx, np.full_like(xx, y), zz], axis=-1).reshape(-1, 3)
    pos -= pos.mean(0) * np.array([1.0, 0.0, 1.0])
    return pos.astype(np.float32)


@pytest.mark.parametrize("mesh", ["1", "0"])
def test_cloth_mesh_on_and_off(mesh, monkeypatch, request):
    """tests/test_render_cloth_mesh.py's near-top-down sheet, its grid
    sparser than the splats so the mesh raster fills the gaps; the JAX
    switch is read at trace time, so its caches are cleared around it."""
    monkeypatch.setenv("ADAPTIGRAPH_CLOTH_MESH", mesh)
    jax.clear_caches()
    request.addfinalizer(jax.clear_caches)
    dimx, dimz = 12, 10
    pos = _flat_grid(dimx, dimz, 0.15)
    tilt, h = 0.08, 3.0
    fwd = np.array([0.0, -1.0, tilt], np.float32)
    cam = (np.array([0.0, h, -tilt * h], np.float32),
           fwd / np.linalg.norm(fwd),
           np.array([80.0, 80.0, 48.0, 48.0], np.float32))
    box = dict(kinds=[0], sizes=[[0.1, 0.1, 0.1]], poses=[[0.0, -10.0, 0.0]],
               quats=[[0.0, 0.0, 0.0, 1.0]])
    n = pos.shape[0]
    fj, ft = _both(pos, np.full((n, 3), 0.5, np.float32), np.ones(n, bool),
                   box, cam, width=96, height=96, splat_px=0,
                   point_radius=1e-4, cloth_dims=(dimx, dimz))
    _hold(fj, ft)
    covered = (ft[..., 4] > 0).sum()
    assert covered > (2000 if mesh == "1" else 0)


def test_draped_cloth_shading():
    dimx = dimz = 16
    xs, zs = np.meshgrid(np.arange(dimx), np.arange(dimz), indexing="xy")
    x = (xs.ravel() - dimx / 2) * 0.3
    z = (zs.ravel() - dimz / 2) * 0.3
    y = 0.6 + 0.6 * np.sin(x * 2.0) * np.cos(z * 2.0)
    pts = np.stack([x, y, z], 1).astype(np.float32)
    n = dimx * dimz
    colors = np.tile(np.array([[0.2, 0.4, 1.0]], np.float32), (n, 1))
    fj, ft = _both(pts, colors, np.ones(n, bool), _plane(), _cam(96),
                   width=96, height=96, point_radius=0.2, splat_px=3,
                   cloth_dims=(dimx, dimz))
    _hold(fj, ft)
    np.testing.assert_allclose(
        trender.cloth_vertex_normals(torch.as_tensor(pts), dimx, dimz).numpy(),
        np.asarray(jrender.cloth_vertex_normals(jnp.asarray(pts), dimx, dimz)),
        rtol=0, atol=1e-6)
    np.testing.assert_array_equal(trender._cloth_grid_faces(7, 5),
                                  jrender._cloth_grid_faces(7, 5))


def test_frames_batch_and_store_quantised():
    """Two frames x two cameras of particles over the floor, a box and a
    capsule, each frame with its own shape poses: the batch equals its
    frames rendered one by one, and the quantised stores agree with JAX's
    but for values off by one."""
    rng = np.random.RandomState(0)
    f, n = 2, 40
    pos = (rng.rand(f, n, 3) * [1.0, 0.5, 1.0] + [-0.5, 0.3, -0.5]).astype(
        np.float32)
    colors = rng.rand(n, 3).astype(np.float32)
    active = np.ones((f, n), bool)
    active[1, ::3] = False
    args = dict(kinds=[2, 0, 1], sizes=[[0, 0, 0], [0.3, 0.2, 0.3],
                                         [0.1, 0.4, 0]],
                poses=[[0, 0, 0], [0.6, 0.2, 0.0], [-0.5, 0.6, 0.2]],
                quats=[[0, 0, 0, 1]] * 3)
    spos = np.stack([np.asarray(args["poses"], np.float32)] * f)
    spos[1, 2] += [0.2, 0.1, 0.0]
    squat = np.tile(np.array([[0, 0, 0, 1.0]], np.float32), (f, 3, 1))
    squat[1, 1] = [0, 0.38, 0, 0.92]
    rig = CameraRig(64, 64)
    cam_pos, cam_ang, _, _ = rig.multiview()
    cam_fwd = np.stack([_fwd_from_angle(a) for a in cam_ang[:2]])
    intr = (rig.intrinsics()).astype(np.float32)
    kw = dict(width=64, height=64)
    cj, dj = jrender.render_frames_store(
        jnp.asarray(pos), jnp.asarray(colors), jnp.asarray(active),
        _shapes(jstate, **args), jnp.asarray(spos), jnp.asarray(squat),
        jnp.asarray(cam_pos[:2]), jnp.asarray(cam_fwd), jnp.asarray(intr), **kw)
    targs = [torch.as_tensor(x) for x in (pos, colors, active)]
    tsh = _shapes(tstate, **args)
    tcam = [torch.as_tensor(x) for x in (spos, squat, cam_pos[:2], cam_fwd,
                                         intr)]
    frames = trender.render_frames_batch(*targs, tsh, *tcam, **kw)
    for fi in range(f):
        sh = tsh._replace(pos=tcam[0][fi], quat=tcam[1][fi])
        for ci in range(2):
            one = trender.render_frame(targs[0][fi], targs[1], targs[2][fi],
                                       sh, tcam[2][ci], tcam[3][ci], tcam[4],
                                       **kw)
            assert torch.equal(frames[fi, ci], one)
    ct, dt = trender.render_frames_store(*targs, tsh, *tcam, **kw)
    cj, dj = np.asarray(cj), np.asarray(dj)
    assert ct.dtype == np.uint8 and dt.dtype == np.uint16
    assert ct.shape == cj.shape == (f, 2, 64, 64, 3)
    assert dt.shape == dj.shape == (f, 2, 64, 64)
    for a, b in ((ct, cj), (dt, dj)):
        gap = np.abs(a.astype(np.int64) - b.astype(np.int64))
        off = gap > 0
        # beyond one only on silhouettes (whole surfaces differ there)
        sil = np.stack([[trender.silhouette_pixels(dj[fi, ci] / 1000.0)
                         for ci in range(2)] for fi in range(f)])
        if a.ndim == 5:
            sil = sil[..., None]
        assert not ((gap > 1) & ~sil).any()
        assert off.sum() <= _MAX_OFF_BY_ONE * a.size, int(off.sum())
