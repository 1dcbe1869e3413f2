"""Port parity: the rope builder of adaptigraph_torch.scenes against the JAX
builder (the granular builder's tests are in test_torch_granular.py). The same RandomState seed must give the same scene: every array of
state and spec matches, integer and boolean arrays exactly and float arrays
to 1e-6 (both builders are host numpy; the float tolerance covers only the
device put)."""

import numpy as np
import pytest
import torch

from adaptigraph_tpu.engine import state as jstate
from adaptigraph_tpu.scenes import build_scene as j_build_scene
from adaptigraph_tpu.scenes.build import Caps as JCaps
from adaptigraph_torch.engine import state as tstate
from adaptigraph_torch.scenes import build_scene, sample_scene
from adaptigraph_torch.scenes.build import Caps

_OVERRIDES = {
    # the samplers' own draw
    "sampled": None,
    # bench.py's rope, lifted to the sampler's height
    "bench_lifted": {"length": 6.0, "translation": np.array([0.0, 0.5, 0.0]),
                     "z_rotation": 0.0, "y_rotation": 90.0},
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _shapes(mod):
    return mod.make_shapes([jstate.SHAPE_PLANE, jstate.SHAPE_BOX],
                           [[0, 0, 0], [0.05, 0.4, 0.8]],
                           [[0, 0, 0], [0, 0.4, 0]],
                           [[0, 0, 0, 1], [0, 0, 0, 1]], m_max=2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("variant", sorted(_OVERRIDES))
def test_rope_builder_matches_jax(seed, variant):
    ov = _OVERRIDES[variant]
    jb = j_build_scene("rope", np.random.RandomState(seed),
                       shapes=_shapes(jstate),
                       caps=JCaps(n=512, s=0, c=128, k=640, m=2),
                       scene_overrides=ov)
    tb = build_scene("rope", np.random.RandomState(seed),
                     shapes=_shapes(tstate),
                     caps=Caps(n=512, s=0, c=128, k=640, m=2),
                     scene_overrides=ov, device="cpu")
    assert (tb.n_active, tb.substeps, tb.iterations) == (
        jb.n_active, jb.substeps, jb.iterations)
    assert tb.props == jb.props
    j_spec = tstate.tree_to_numpy(jb.spec)
    # the rope has no springs: neither spring table is built
    for k in ("spring_inc", "offset_springs"):
        assert j_spec[k] is None
    assert j_spec["cluster_seg"] is None  # the ball cover overlaps
    for name, (jt, tt) in (("state", (jb.state, tb.state)),
                           ("spec", (j_spec, tb.spec))):
        jf = _flat(jt if isinstance(jt, dict) else tstate.tree_to_numpy(jt))
        tf = _flat(tstate.tree_to_numpy(tt))
        assert sorted(jf) == sorted(tf), name
        for key in jf:
            a, b = jf[key], tf[key]
            if a is None or b is None:
                assert a is None and b is None, key
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, key
            if a.dtype.kind == "f" or b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                           err_msg=f"{name}.{key}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{key}")
    assert tb.spec.cluster_mm is not None  # the rope takes the matmul pass
    assert tb.spec.global_rest.shape[0] == 0  # global cluster folded in


def test_unported_materials_raise():
    """Every material of the JAX package is ported: cloth samples and
    builds (its sampler's draw equals the JAX sampler's; tests/
    test_torch_cloth.py holds the build against JAX). An unknown material
    still raises ValueError."""
    from adaptigraph_tpu.scenes.samplers import sample_scene as j_sample

    rng = np.random.RandomState(0)
    scene, props = sample_scene("cloth", rng)
    j_scene, j_props = j_sample("cloth", np.random.RandomState(0))
    assert props == j_props and sorted(scene) == sorted(j_scene)
    for k in scene:
        np.testing.assert_array_equal(np.asarray(scene[k]),
                                      np.asarray(j_scene[k]), err_msg=k)
    b = build_scene("cloth", np.random.RandomState(0),
                    caps=Caps(n=640, s=4096, c=0, k=0, m=2), device="cpu",
                    scene_overrides={"dimx": 24, "dimz": 24})
    assert b.n_active == 576 and (b.substeps, b.iterations) == (4, 50)
    assert b.spec.offset_springs.offsets == (1, 24, 23, 25, 2, 48)
    with pytest.raises(ValueError):
        sample_scene("sand", rng)
    with pytest.raises(ValueError):
        build_scene("sand", rng, device="cpu")


def test_scene_round_trips_through_numpy():
    """scene_from_numpy inverts tree_to_numpy on the port's own scene."""
    tb = build_scene("rope", np.random.RandomState(3),
                     caps=Caps(n=512, s=0, c=128, k=640, m=2), device="cpu")
    st, spec = tstate.scene_from_numpy(tstate.tree_to_numpy(tb.state),
                                       tstate.tree_to_numpy(tb.spec), "cpu")
    for a, b in ((st, tb.state), (spec, tb.spec)):
        fa = _flat(tstate.tree_to_numpy(a))
        fb = _flat(tstate.tree_to_numpy(b))
        assert sorted(fa) == sorted(fb)
        for k in fa:
            if fa[k] is None:
                assert fb[k] is None
            else:
                assert fa[k].dtype == fb[k].dtype, k
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert st.particles.group.dtype == torch.int32


class _Made(Exception):
    """Raised by the make_shapes spy once it has seen its device."""


def test_design_points_make_shapes_on_the_resolved_device(monkeypatch):
    """rope_design_point and granular_shapes hand make_shapes the device
    resolve_device gives (CUDA when none is named), never None: shapes and
    particles then land on one device. With no device and no GPU both raise
    before they make anything; with a device named, shapes and particles
    are on it."""
    from adaptigraph_torch.scenes import design_point as dp

    seen = []

    def spy(*args, device=None, **kw):
        seen.append(device)
        raise _Made

    monkeypatch.setattr(dp, "make_shapes", spy)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for make in (dp.rope_design_point, dp.granular_shapes):
        with pytest.raises(_Made):
            make()
    assert seen == [torch.device("cuda")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (dp.rope_design_point, dp.granular_shapes):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert len(seen) == 2
    monkeypatch.undo()
    assert dp.granular_shapes("cpu").pos.device == torch.device("cpu")
    b = dp.rope_design_point("cpu")
    assert b.state.shapes.pos.device == b.state.particles.pos.device
    assert b.state.particles.pos.device == torch.device("cpu")
