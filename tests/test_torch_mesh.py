"""Port parity: the port's copy of the mesh toolkit (scenes/mesh.py) and
the OBJ-driven rope against the JAX package. tests/test_mesh.py's cases
run on both copies and give the same results: meshes, queries and
samples exactly (both are the same numpy calls); the soft body built from
a mesh settles in the port's engine as in JAX's, through the scatter
forms of the spring and cluster passes (a hand-built spec has no
incidence tables), within 1e-4 over 5 frames. OBJ files are written into
pytest's tmp_path.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from adaptigraph_tpu.scenes import mesh as jmesh
from adaptigraph_tpu.scenes import build_scene as j_build_scene
from adaptigraph_torch.scenes import mesh as tmesh
from adaptigraph_torch.scenes import build_scene
from adaptigraph_torch.engine import state as tstate


def _equal(a, b):
    """Results of the two copies, equal leaf for leaf."""
    if isinstance(a, (list, tuple)):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b or (a != a and b != b), (a, b)


def _io(mod, tmp_path):
    m = mod.make_box_mesh((0.3, 0.5, 0.7))
    p = tmp_path / f"box_{mod.__name__.split('.')[0]}.obj"
    mod.export_obj(m, str(p))
    q = tmp_path / "quad.obj"
    q.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                 "f 1/1/1 2/2/2 3/3/3 4/4/4\nf -4 -3 -2\n")
    return [p.read_text(), mod.import_obj(str(p)), mod.import_obj(str(q))]


def _transforms(mod, tmp_path):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [1, 2, 3]
    m = mod.make_box_mesh((1.0, 2.0, 0.5))
    return [m.translated([3, -1, 2]).normalized(), m.transformed(t),
            m.transformed(np.eye(3) * 2), m.scaled([1, 2, 3]),
            mod.make_cylinder_mesh(2.0, 0.2), mod.make_icosphere(0.5, 2)]


def _closest(mod, tmp_path):
    mesh = mod.make_icosphere(radius=0.5, subdiv=1)
    q = np.random.RandomState(0).randn(40, 3) * 0.8
    tri = mesh.triangles().astype(np.float64)
    return [mod.AABBTree(mesh).closest_point(q),
            mod._closest_on_triangles(np.broadcast_to(q[0], (len(tri), 3)),
                                      tri)]


def _raycast(mod, tmp_path):
    return list(mod.raycast(mod.make_box_mesh(), [[-2, 0.1, 0.1], [-2, 5, 0]],
                            [[1, 0, 0], [1, 0, 0]]))


def _voxel_sdf(mod, tmp_path):
    sdf = mod.signed_distance_grid(mod.make_box_mesh(), dims=12, margin=3)
    return [mod.voxelize(mod.make_box_mesh(), dx=0.05),
            mod.voxelize(mod.make_icosphere(0.5, 2), dims=(20, 20, 20)),
            sdf, sdf.sample([[0.0, 0.0, 0.0], [0.6, 0.0, 0.0]])]


def _sample_soft(mod, tmp_path):
    pts = np.random.RandomState(0).rand(200, 3).astype(np.float32)
    m = mod.make_cylinder_mesh(length=2.0, radius=0.2)
    asset = mod.soft_from_mesh(m.translated([5, 5, 5]), particle_radius=0.1,
                               cluster_spacing=2.0, link_radius=2.5,
                               global_stiffness=0.02)
    return [mod.sample_mesh(m, radius=0.08),
            mod.sample_mesh(m, radius=0.08, surface_samples=50),
            list(mod._pairs_within(pts, 0.2)), asset]


_CASES = {"obj_io": _io, "transforms": _transforms, "closest_point": _closest,
          "raycast": _raycast, "voxelize_sdf": _voxel_sdf,
          "sample_and_soft": _sample_soft}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_mesh_toolkit_matches_jax(case, tmp_path):
    _equal(_CASES[case](tmesh, tmp_path), _CASES[case](jmesh, tmp_path))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_obj_rope_matches_jax(tmp_path):
    """tests/test_scenes.py:112's OBJ-driven rope (a cylinder OBJ scaled to
    the sampler's rope), built array for array at the rope's caps: the
    same sampled particles, clusters, matmul tables and pins."""
    obj = tmp_path / "rope.obj"
    tmesh.export_obj(tmesh.make_cylinder_mesh(length=1.0, radius=0.0165),
                     str(obj))
    ov = {"mesh_path": str(obj)}
    jb = j_build_scene("rope", np.random.RandomState(0), scene_overrides=ov)
    tb = build_scene("rope", np.random.RandomState(0), scene_overrides=ov,
                     device="cpu")
    assert tb.n_active == jb.n_active and tb.props == jb.props
    w = tb.state.particles.inv_mass[: tb.n_active]
    assert 0 < int((w == 0).sum()) < tb.n_active  # the y < 0.4 pin rule
    for jt, tt in ((jb.state, tb.state), (jb.spec, tb.spec)):
        jf = _flat(tstate.tree_to_numpy(jt))
        tf = _flat(tstate.tree_to_numpy(tt))
        assert sorted(jf) == sorted(tf)
        for k in jf:
            if jf[k] is None:
                assert tf[k] is None, k
                continue
            a, b = np.asarray(jf[k]), np.asarray(tf[k])
            if a.ndim == 0 and a.dtype.kind == "f":  # solver parameters
                np.testing.assert_allclose(a, b, rtol=1e-7, err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


def test_soft_asset_settles_as_in_jax():
    """tests/test_mesh.py's mesh-built soft body, dropped on the floor:
    5 frames on both sides (springs and clusters without incidence
    tables, so the scatter forms of both passes), then 35 more on the
    port, which stays finite and comes to rest on the plane."""
    from adaptigraph_tpu.engine import state as jstate
    from adaptigraph_tpu.engine import xpbd_step as j_step
    from adaptigraph_torch.engine.solver import xpbd_step

    asset = jmesh.soft_from_mesh(jmesh.make_cylinder_mesh(1.2, 0.15),
                                 particle_radius=0.1, cluster_spacing=3.0,
                                 cluster_stiffness=0.6, link_radius=2.5)
    pts = asset.points + np.array([0, 0.5, 0], dtype=np.float32)
    clusters = jstate.make_clusters(asset.clusters, pts,
                                    asset.cluster_stiffness)
    spec = jstate.SceneSpec(
        springs=jstate.make_springs(asset.spring_idx, asset.spring_rest,
                                    asset.spring_stiffness),
        clusters=clusters, global_stiffness=jnp.float32(0.0),
        global_rest=jnp.zeros((0, 3)), rest_pos=jnp.asarray(pts),
        params=jstate.SolverParams(radius=jnp.float32(0.1),
                                   collision_distance=jnp.float32(0.05)))
    st = jstate.SceneState(
        particles=jstate.make_particles(pts, group=0, self_collide=True),
        shapes=jstate.make_shapes([jstate.SHAPE_PLANE], [[0, 0, 0]],
                                  [[0, 0, 0]], [[0, 0, 0, 1]]),
        cluster_rot=jnp.tile(jnp.array([0.0, 0, 0, 1.0]),
                             (clusters.stiffness.shape[0], 1)),
        global_rot=jnp.array([0.0, 0, 0, 1.0]))
    ts, tspec = tstate.scene_from_numpy(tstate.tree_to_numpy(st),
                                        tstate.tree_to_numpy(spec), "cpu")
    assert tspec.spring_inc is None and tspec.cluster_inc is None
    assert tspec.springs.idx.shape[0] > 0
    for _ in range(5):
        st = j_step(st, spec, substeps=2, iterations=4)
        ts = xpbd_step(ts, tspec, 2, 4)
    np.testing.assert_allclose(ts.particles.pos.numpy(),
                               np.asarray(st.particles.pos), rtol=0,
                               atol=1e-4)
    for _ in range(35):
        ts = xpbd_step(ts, tspec, 2, 4)
    pos = ts.particles.pos[: len(pts)]
    assert bool(torch.isfinite(pos).all())
    assert float(pos[:, 1].min()) > -0.05 and float(pos[:, 1].max()) < 0.6
