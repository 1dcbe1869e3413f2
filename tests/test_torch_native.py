"""Port parity: the native host libraries (native/fps.cpp and
native/shm_ring.cpp, built by kernels.build's host route) against their
numpy forms and the JAX package's, on the CPU.

The JAX package loads the committed adaptigraph_tpu/native/*.so; the port
builds the same sources with g++ into adaptigraph_torch/kernels/_build/.
- FPS: the index lists equal, ties included (a lattice), native against
  numpy against JAX's.
- The ring, the queue and the counter as tests/test_real_world.py:13-84
  has them, in both forms; a producer in a second process; and the JAX
  package's ring writing one named segment that the port's ring reads,
  and the other way round (one layout, native/shm_ring.cpp:10-16).
Segment names carry the pid: concurrent test workers never share one.
"""

import multiprocessing as mp
import os
from multiprocessing import shared_memory

import numpy as np
import pytest

from adaptigraph_tpu.planning.real_world import shared_memory as jshm
from adaptigraph_tpu.utils import host_fps as jfps
from adaptigraph_torch.kernels import build
from adaptigraph_torch.planning.real_world.shared_memory import (
    SharedAtomicCounter, SharedMemoryQueue, SharedMemoryRingBuffer)
from adaptigraph_torch.utils import host_fps as tfps

_PID = os.getpid()


def _name(tag):
    return f"agtorch_test_{tag}_{_PID}"


# ---------- the host build ----------

def test_host_build_is_hashed_and_reused():
    build.build_host("fps")  # current, or built now
    target = build._host_target("fps")
    assert target.exists() and target.parent == build.BUILD_DIR
    assert build.build_host("fps") is None  # nothing to do
    assert target.name.startswith("libfps-")
    assert build.load_host("fps") is build.load_host("fps")


def test_host_build_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g.. not found"):
        build.find_cxx()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "empty")
    with pytest.raises(RuntimeError, match="g.. not found"):
        build.build_host("fps")


def test_host_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(build, "NATIVE", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="broken.cpp") as e:
        build.build_host("broken")
    assert "error" in str(e.value)
    assert not list((tmp_path / "out").glob("*.so"))


# ---------- FPS ----------

def _clouds():
    rng = np.random.RandomState(0)
    lattice = np.stack(np.meshgrid(*(np.arange(6.0),) * 3, indexing="ij"),
                       -1).reshape(-1, 3).astype(np.float32) * 0.1
    return {"random": rng.rand(700, 3).astype(np.float32),
            "lattice": lattice,
            "float64": rng.rand(300, 3)}


@pytest.mark.parametrize("cloud", ["random", "lattice", "float64"])
def test_fps_index_lists_equal_jax_and_plain(cloud):
    pts = _clouds()[cloud]
    assert jfps._load(), "the JAX package's libfps.so should load"
    for n in (1, 17, 120, len(pts), len(pts) + 5):
        p_nat, i_nat = tfps.fps_with_idx(pts, n)
        _, i_plain = tfps.fps_with_idx(pts, n, native=False)
        _, i_jax = jfps.fps_with_idx(pts, n)
        np.testing.assert_array_equal(i_nat, i_plain)
        np.testing.assert_array_equal(i_nat, i_jax)
        np.testing.assert_array_equal(p_nat, pts[i_nat])
    for radius in (0.05, 0.15, 0.4):
        got = [f(pts, radius, np.random.RandomState(3), **kw)[1]
               for f, kw in ((tfps.fps_rad_idx, {}),
                             (tfps.fps_rad_idx, {"native": False}),
                             (jfps.fps_rad_idx, {}))]
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], got[2])
        assert len(got[0]) > 1


# ---------- the ring, the queue, the counter ----------

@pytest.mark.parametrize("native", [True, False])
def test_ring_roundtrip(native):
    specs = {"a": ((4, 3), np.float32), "ts": ((1,), np.float64)}
    ring = SharedMemoryRingBuffer(_name(f"ring{native}"), specs, capacity=4,
                                  native=native)
    try:
        assert ring.get_latest() == (None, -1)
        assert ring.get_last_k(3) == []
        for i in range(6):  # wraps the capacity
            ring.put({"a": np.full((4, 3), i, np.float32),
                      "ts": np.array([i * 0.1])})
        f, seq = ring.get_latest()
        assert seq == 5
        np.testing.assert_array_equal(f["a"], np.full((4, 3), 5.0))
        assert [int(x["a"][0, 0]) for x in ring.get_last_k(3)] == [3, 4, 5]
        assert len(ring.get_last_k(9)) == 4  # no more than the ring holds
        assert ring.count == 6
    finally:
        ring.close()


@pytest.mark.parametrize("native", [True, False])
def test_queue_fifo_and_full(native):
    q = SharedMemoryQueue(_name(f"q{native}"), {"x": ((2,), np.int64)},
                          capacity=3, native=native)
    try:
        for i in range(3):
            assert q.put({"x": np.array([i, i])})
        assert not q.put({"x": np.array([9, 9])})  # full
        assert q.qsize() == 3
        assert [int(q.get()["x"][0]) for _ in range(3)] == [0, 1, 2]
        assert q.get() is None and q.qsize() == 0
        assert q.put({"x": np.array([4, 4])})  # wraps
        assert int(q.get()["x"][1]) == 4
    finally:
        q.close()


@pytest.mark.parametrize("native", [True, False])
def test_atomic_counter(native):
    shm = shared_memory.SharedMemory(name=_name(f"ctr{native}"), create=True,
                                     size=16)
    try:
        c = SharedAtomicCounter(shm, offset=8, native=native)
        c.store(5)
        assert c.load() == 5
        assert c.add(3) == 8 and c.add() == 9
        assert int(np.frombuffer(shm.buf, np.int64, 1, 8)[0]) == 9
        del c
    finally:
        shm.close()
        shm.unlink()


def _produce(name, specs, n):
    ring = SharedMemoryRingBuffer(name, specs, capacity=8, create=False)
    for i in range(n):
        ring.put({"v": np.full(8, i, np.float32)})
    ring.close(unlink=False)


def test_cross_process_ring():
    specs = {"v": ((8,), np.float32)}
    name = _name("xproc")
    ring = SharedMemoryRingBuffer(name, specs, capacity=8)
    try:
        p = mp.Process(target=_produce, args=(name, specs, 20))
        p.start()
        p.join(30)
        assert p.exitcode == 0
        f, seq = ring.get_latest()
        assert seq == 19
        np.testing.assert_array_equal(f["v"], np.full(8, 19.0))
        assert [int(x["v"][0]) for x in ring.get_last_k(8)] == list(
            range(12, 20))
    finally:
        ring.close()


def test_jax_and_port_rings_share_one_segment():
    """JAX's ring writes a named segment that the port's ring reads (its
    frames, sequence numbers and count), then the port writes and JAX
    reads: one layout."""
    assert jshm._lib() is not None, "the JAX package's libshm_ring.so"
    specs = {"color": ((6, 5, 3), np.uint8), "depth": ((6, 5), np.uint16),
             "ts": ((1,), np.float64)}
    rng = np.random.RandomState(0)
    frames = [{"color": rng.randint(0, 256, (6, 5, 3)).astype(np.uint8),
               "depth": rng.randint(0, 9000, (6, 5)).astype(np.uint16),
               "ts": np.array([0.5 * i])} for i in range(7)]
    name = _name("shared")
    jring = jshm.SharedMemoryRingBuffer(name, specs, capacity=4)
    try:
        tring = SharedMemoryRingBuffer(name, specs, capacity=4, create=False)
        assert tring.slot_size == jring.slot_size
        for f in frames[:5]:
            jring.put(f)
        got, seq = tring.get_latest()
        assert seq == 4 and tring.count == 5
        for a, b in zip(tring.get_last_k(4), frames[1:5]):
            for k in specs:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        for f in frames[5:]:
            tring.put(f)
        j_got, j_seq = jring.get_latest()
        assert j_seq == 6
        for k in specs:
            np.testing.assert_array_equal(j_got[k], frames[6][k])
        tring.close()
    finally:
        jring.close()
    assert name not in os.listdir("/dev/shm")


def test_smoke_native_path_runs_on_the_cpu():
    """chip_smoke.py's native phase on the CPU: both libraries built,
    FPS native against numpy, 4 frames through a ring from a second
    process, a RealEnv with its doubles, no shared memory left."""
    import chip_smoke as cs

    rng = np.random.RandomState(0)
    frames = [((rng.rand(24, 32, 3) * 255).astype(np.uint8),
               (rng.rand(24, 32) * 9000).astype(np.uint16)) for _ in range(4)]
    pts = rng.rand(800, 3).astype(np.float32) * [4.0, 0.1, 1.0]
    r = cs.native_phases(frames, pts)
    assert r["ok"] and r["fps_equal"] and r["ring_equal_bytes"]
    assert r["real_env_cameras"] == 4 and not r["shm_left"]
