"""Port parity: utils/visualize.py (projection, the graph and planning
overlays, the video) and its two callers, the rollout's viz and plan()'s
overlay, against the JAX package on the CPU.

Both packages draw with the same cv2 on the same numpy inputs, so the
overlays are held equal pixel for pixel; the planning overlay's edges come
from each package's build_edges_slotted, whose edge lists are equal
(tests/test_torch_edges.py), so the lines fall on the same pixels.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from adaptigraph_tpu.dynamics import rollout as jroll
from adaptigraph_tpu.sim import episode_io as jio
from adaptigraph_tpu.utils import visualize as jvis
from adaptigraph_torch.dynamics import rollout as troll
from adaptigraph_torch.planning import plan as tplan
from adaptigraph_torch.sim import episode_io as tio
from adaptigraph_torch.sim.cameras import CameraRig
from adaptigraph_torch.utils import visualize as tvis
from tests.test_torch_loop import rope, sim  # noqa: F401 (fixtures)
from tests.test_torch_plan import FramesEnv
from tests.test_torch_plan import _task as _loop_task

H = W = 96


def _camera():
    _, _, intr, extr = CameraRig(W, H).multiview()
    return intr[0], extr[0]


def _cloud(seed, n=40):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1.5, 1.5, (n, 3)) * [1, 0.1, 1]
            + [0, 0.6, 0]).astype(np.float32)


def _image(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (H, W, 3)).astype(
        np.uint8)


def test_project_points_matches_jax():
    intr, extr = _camera()
    pts = _cloud(0)
    for a, b in zip(tvis.project_points(pts, intr, extr),
                    jvis.project_points(pts, intr, extr)):
        np.testing.assert_array_equal(a, b)
    for units in ("sim", "real"):
        np.testing.assert_array_equal(tvis.plan_to_world(pts, units),
                                      jvis.plan_to_world(pts, units))


def test_overlay_graph_matches_jax_pixel_for_pixel():
    intr, extr = _camera()
    kp, gt = _cloud(1), _cloud(2)
    rng = np.random.RandomState(3)
    edges = (rng.randint(0, 45, 60), rng.randint(0, 40, 60), rng.rand(60) > 0.3)
    for kw in ({}, {"edges": edges, "gt_kp": gt,
                    "eef_kp": np.array([[0.2, 0.8, 0.1]], np.float32)}):
        a = tvis.overlay_graph(_image(), kp, intr, extr, **kw)
        b = jvis.overlay_graph(_image(), kp, intr, extr, **kw)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, _image())


@pytest.mark.parametrize("target", ["pcd", "box", "none"])
@pytest.mark.parametrize("units", ["sim", "real"])
def test_overlay_plan_matches_jax_pixel_for_pixel(target, units):
    intr, extr = _camera()
    ratio = 10.0 if units == "real" else 1.0
    scale = 0.1 if units == "real" else 1.0
    init, pred = _cloud(4) * [1, 1, -1], _cloud(5) * [1, 1, -1]
    if units == "real":
        intr = intr.copy()
        init, pred = init * ratio * scale * 10, pred * ratio * scale * 10
    kw = dict(target_state=_cloud(6) if target == "pcd" else None,
              target_box=(np.array([-0.5, 0.5, -0.4, 0.4]) if target == "box"
                          else None),
              push_length=0.1, adj_thresh=0.3, topk=5, units=units,
              sim_real_ratio=ratio if units == "real" else 10.0)
    act = np.array([0.3, -0.2, 0.7, 4.0])
    a = tvis.overlay_plan(_image(), init, pred, act, intr, extr, **kw)
    b = jvis.overlay_plan(_image(), init, pred, act, intr, extr, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _image())


def test_merge_video_matches_jax(tmp_path):
    for name in ("port", "jax"):
        os.makedirs(tmp_path / name)
        for i in range(5):
            cv2.imwrite(str(tmp_path / name / f"{i}_both.jpg"), _image(i))
    assert not tvis.merge_video(str(tmp_path / "port"), "none",
                                str(tmp_path / "x.mp4"))
    outs = []
    for name, mod in (("port", tvis), ("jax", jvis)):
        out = str(tmp_path / f"{name}.mp4")
        assert mod.merge_video(str(tmp_path / name), "both", out, fps=10)
        cap = cv2.VideoCapture(out)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        outs.append(np.stack(frames))
    assert outs[0].shape == (5, H, W, 3)
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------- the rollout's viz ----------

def _episode_dirs(tmp_path):
    """An episode of two pushes in the port's NN.npz form with random
    frames, its h5 copy for JAX, and the cameras' parameters."""
    rng = np.random.RandomState(0)
    _, _, intr, extr = CameraRig(W, H).multiview()
    for name in ("port", "jax"):
        d = tmp_path / name / "rope"
        os.makedirs(d / "000000")
        os.makedirs(d / "cameras")
        np.save(d / "cameras" / "intrinsic.npy", intr)
        np.save(d / "cameras" / "extrinsic.npy", extr)
    rng = np.random.RandomState(1)
    for step, t in ((0, 1), (1, 3), (2, 2)):
        imgs = [((rng.rand(4, H, W, 3) * 255).astype(np.uint8),
                 (rng.rand(4, H, W) * 9000).astype(np.uint16))
                for _ in range(t)]
        data = (imgs, [rng.rand(30, 3).astype(np.float32)] * t,
                [rng.rand(1, 14).astype(np.float32)] * t)
        npz = tmp_path / "port" / "rope" / "000000" / f"{step:02}.npz"
        tio.store_data(str(npz), data, np.zeros(4))
        jio.save_data(str(tmp_path / "jax" / "rope" / "000000"
                          / f"{step:02}.h5"), tio.load_data(str(npz)))
    return {name: {"data_dir": str(tmp_path / name), "data_name": "rope"}
            for name in ("port", "jax")}


def test_rollout_viz_frames_match_jax(tmp_path):
    """make_viz_ctx over the port's NN.npz equals JAX's _make_viz_ctx over
    the h5 copy, and rollout_push's overlay frames (a stub step giving
    both packages the same prediction and edges) are equal pixel for
    pixel; the rollout's errors equal too."""
    cfgs = _episode_dirs(tmp_path)
    ctx = {"port": troll.make_viz_ctx(cfgs["port"], "000000", 0,
                                      str(tmp_path / "out_port")),
           "jax": jroll._make_viz_ctx(cfgs["jax"], "000000", 0,
                                      str(tmp_path / "out_jax"))}
    for key in ("imgs", "intr", "extr"):
        np.testing.assert_array_equal(ctx["port"][key], ctx["jax"][key])
    assert ctx["port"]["imgs"].shape == (5, H, W, 3)
    assert troll.make_viz_ctx({"data_dir": str(tmp_path / "none"),
                               "data_name": "rope"}, "000000", 0,
                              str(tmp_path)) is None

    n, n_his = 30, 2
    rng = np.random.RandomState(2)
    obj = rng.uniform(-1, 1, (6, n, 3)).astype(np.float32) * [1, 0.1, 1]
    eef = rng.uniform(-1, 1, (6, 1, 3)).astype(np.float32)
    pairs = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4], [3, 4, 5]])
    recv, send = rng.randint(0, n, 50), rng.randint(0, n, 50)
    valid = rng.rand(50) > 0.2
    fps_idx = np.arange(n)

    def step(to):
        def fn(params, graph, eef_start, eef_end):
            pred = obj[int(graph["t"])] + 0.05
            g = dict(graph, t=graph["t"] + 1, recv=to(recv), send=to(send),
                     edge_valid=to(valid))
            return to(np.concatenate([pred, np.asarray(eef_start)])), g
        return fn

    errs = {}
    for name, mod, to in (("port", troll, torch.as_tensor),
                          ("jax", jroll, np.asarray)):
        graph = {"t": 1, "state": torch.zeros((n_his, n + 1, 3))}
        errs[name] = mod.rollout_push(
            None, step(to), graph, fps_idx, pairs, eef, obj, n_his, 1, 2, n,
            rollout_steps=3, viz_ctx=ctx[name], scan=True)
    assert errs["port"] == errs["jax"] and len(errs["port"]) == 3
    files = sorted(os.listdir(ctx["port"]["save_dir"]))
    assert files == sorted(os.listdir(ctx["jax"]["save_dir"])) == [
        "0_both.jpg", "1_both.jpg", "2_both.jpg"]
    for f in files:
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(ctx["port"]["save_dir"], f)),
            cv2.imread(os.path.join(ctx["jax"]["save_dir"], f)))


# ---------- plan()'s overlay ----------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread for this file: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task(tmp_path, target_type):
    target = tmp_path / "target.npy"
    np.save(target, _cloud(7) * 0.1)
    return {"target_type": target_type,
            "target": (str(target) if target_type == "pcd"
                       else [-0.05, 0.05, -0.04, 0.04]),
            "push_length": 0.1, "adj_thresh": 0.3, "topk": 5}


@pytest.mark.parametrize("target_type", ["pcd", "box"])
def test_plan_overlay_file_matches_jax(tmp_path, target_type):
    """plan()'s overlay as written (rgb_vis_<i>.png) equals JAX's plan.py
    overlay (plan.py:276-297) on the same inputs."""
    tc = _task(tmp_path, target_type)
    intr, extr = _camera()
    color = _image(8)
    init, pred = _cloud(9) * [1, 1, -1], _cloud(10) * [1, 1, -1]
    act = np.array([0.1, 0.2, 1.2, 3.0], np.float32)
    path = str(tmp_path / "rgb_vis_0.png")
    tplan._write_overlay(path, tc, "target", color, intr, extr, init, pred,
                         act, "sim", 10.0)
    # JAX's plan(): the same arguments, inline
    tgt_pcd = tgt_box = None
    if target_type == "box":
        tgt_box = np.asarray(tc["target"], np.float32) * 10.0
    else:
        tgt_pcd = np.load(tc["target"]) * 10.0
    ref = jvis.overlay_plan(color, init, pred, act, intr, extr,
                            target_state=tgt_pcd, target_box=tgt_box,
                            push_length=0.1, adj_thresh=0.3, topk=5,
                            units="sim", sim_real_ratio=10.0)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], ref)


def test_plan_writes_its_overlay_and_reports_a_failure_once(
        rope, sim, tmp_path, monkeypatch, capsys):
    """plan() writes rgb_vis_<i>.png a action, equal to JAX's overlay of
    the logged interaction on the frame it planned from; without cv2 (as
    on the card's machine) it draws none, plans on, and prints the reason
    once over two actions."""
    import builtins

    task = _loop_task(target_type="box", target=[-0.05, 0.05, -0.05, 0.05])
    np.random.seed(0)
    env = FramesEnv(sim["frames"], sim["intr"], sim["extr"])
    tplan.plan(task, env, str(tmp_path / "drawn"), rope["params"],
               n_actions=2, n_sample=6, device="cpu")
    for i in range(2):
        log = np.load(tmp_path / "drawn" / f"interaction_{i:03}.npz")
        ref = jvis.overlay_plan(
            sim["frames"][i][0][0], log["state_init"], log["state_pred"],
            log["act"], sim["intr"][0], sim["extr"][0],
            target_box=np.asarray(task["target"], np.float32) * 10.0,
            push_length=float(task["push_length"]),
            adj_thresh=float(task["adj_thresh"]), topk=int(task["topk"]))
        # the frames are float colours: cv2 writes them as JAX's plan() does
        cv2.imwrite(str(tmp_path / "ref.png"), ref[..., ::-1])
        got = cv2.imread(str(tmp_path / "drawn" / f"rgb_vis_{i}.png"))
        np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "ref.png")))

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ModuleNotFoundError("No module named 'cv2'")
        return real_import(name, *a, **k)

    capsys.readouterr()
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    env = FramesEnv(sim["frames"], sim["intr"], sim["extr"])
    stats = tplan.plan(task, env, str(tmp_path / "blind"), rope["params"],
                       n_actions=2, n_sample=6, device="cpu")
    out = capsys.readouterr().out
    assert len(stats) == 2 and len(env.actions) == 2
    assert out.count("the planning overlay is not drawn") == 1
    assert "cv2" in out
    assert not any(f.startswith("rgb_vis")
                   for f in os.listdir(tmp_path / "blind"))
