"""Port scene build against the JAX SceneBuilder, the numpy BVH builder
against the C++ one, and bridge.scene_from_numpy against the port's build."""
import numpy as np
import pytest
import torch

from pbrt_tpu import scene as jsc
from pbrt_tpu.core import transform as jtf
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import scene as tsc
from pbrt_tpu_torch.accel import build as tbuild
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.ops import bvh as kb
import test_torch_threads  # noqa: F401  (torch's threads under xdist)


def demo(sc, tf):
    """__graft_entry__._demo_scene, call for call."""
    b = sc.SceneBuilder()
    matte = b.add_material(sc.MAT_MATTE, kd=(0.5, 0.5, 0.8))
    plastic = b.add_material(sc.MAT_PLASTIC, kd=(0.4, 0.2, 0.2),
                             ks=(0.5, 0.5, 0.5), roughness=0.025)
    b.add_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                        [[-10, -10, 0], [10, -10, 0], [10, 10, 0], [-10, 10, 0]],
                        material=matte)
    rs = np.random.RandomState(0)
    c = rs.randn(64, 1, 3) * 1.5 + np.array([0, 0, 3.0])
    v = c + rs.randn(64, 3, 3) * 0.4
    b.add_triangle_mesh(np.arange(192).reshape(-1, 3), v.reshape(-1, 3),
                        material=plastic)
    b.add_sphere(tf.translate(2, 0, 2), 0.8, material=plastic)
    b.add_emissive_sphere(tf.translate(0, 5, 8), 0.5, L=(40.0, 40.0, 40.0),
                          material=matte)
    return b


def soup(sc, tf, n_tris=200, seed=0):
    """tests/test_pallas_bvh.py:_tri_scene, plus a mirror, an emissive
    triangle pair and the power light strategy."""
    rs = np.random.RandomState(seed)
    b = sc.SceneBuilder()
    m = b.add_material(sc.MAT_MATTE)
    mirror = b.add_material(sc.MAT_MIRROR, kr=(0.8, 0.7, 0.9))
    c = rs.randn(n_tris, 1, 3) * 2.0
    v = c + rs.randn(n_tris, 3, 3) * 0.5
    b.add_triangle_mesh(np.arange(3 * n_tris).reshape(-1, 3), v.reshape(-1, 3),
                        material=m)
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, -3], [1, 0, -3], [0, 1, -3]],
                        n=[[0, 0, 1], [0, 0.1, 1], [0.1, 0, 1]],
                        uv=[[0, 0], [1, 0], [0, 1]], material=mirror,
                        object_to_world=tf.rotate(20, 1, 0, 0))
    b.add_emissive_triangle_mesh([[0, 1, 2], [2, 3, 0]],
                                 [[-1, -1, 6], [1, -1, 6], [1, 1, 6], [-1, 1, 6]],
                                 L=(3.0, 3.0, 3.0), material=m, two_sided=True)
    b.add_point_light(tf.translate(0, 0, 5), (1, 1, 1))
    b.light_strategy = "power"
    return b


def _jax_fields(scene):
    return bridge.as_numpy_fields(scene)


@pytest.mark.parametrize("make", [demo, soup], ids=["demo", "soup"])
def test_builder_matches_jax(make):
    ref = _jax_fields(make(jsc, jtf).build())
    got = make(tsc, ttf).build_numpy()
    for k in ("bvh_offset", "bvh_nprims", "bvh_axis", "prim_meta",
              "tri_indices", "q_type", "q_rev", "q_prim_id"):
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    for k in ("bvh_min", "bvh_max", "tri_p", "tri_attr", "tri_verts", "q_w2o",
              "q_o2w", "q_params", "q_packed"):
        np.testing.assert_allclose(ref[k], got[k], rtol=1e-6, err_msg=k)
    for k in tsc.MATERIAL_FIELDS:
        np.testing.assert_allclose(ref["materials"][k], got["materials"][k],
                                   rtol=1e-6, err_msg=k)
    for k in tsc.LIGHT_FIELDS:
        np.testing.assert_allclose(ref["lights"][k], got["lights"][k],
                                   rtol=1e-6, err_msg=k)
    for k in ("func", "cdf", "func_int"):
        np.testing.assert_allclose(ref["light_distr"][k], got["light_distr"][k],
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 2000])
def test_numpy_builder_matches_native(n):
    rs = np.random.RandomState(n)
    c = rs.randn(n, 3) * 5
    e = rs.rand(n, 3) * 0.5
    a = tbuild.build_bvh(c - e, c + e, 4, method="numpy")
    b = tbuild.build_bvh(c - e, c + e, 4, method="native")
    for k in ("order", "offset", "n_prims", "axis"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    np.testing.assert_allclose(a.nodes_min, b.nodes_min, rtol=1e-6)
    np.testing.assert_allclose(a.nodes_max, b.nodes_max, rtol=1e-6)


@pytest.mark.parametrize("make", [demo, soup], ids=["demo", "soup"])
def test_bridge_matches_own_build(make):
    own = make(tsc, ttf).build(device="cpu")
    via = bridge.scene_from_numpy(_jax_fields(make(jsc, jtf).build()), "cpu")
    # bvh4_nodes hold int32 refs and counts bit for bit: compare the bits.
    assert torch.equal(own.bvh4_nodes.view(torch.int32),
                       via.bvh4_nodes.view(torch.int32))
    for f in ("prim_meta", "prim_tris", "q_packed", "tri_attr"):
        a, b = getattr(own, f), getattr(via, f)
        assert a.dtype == b.dtype, f
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=f)
    for f in ("bvh4_depth", "mat_types", "light_types", "quadric_types",
              "quadric_rows"):
        assert getattr(own, f) == getattr(via, f), f
    torch.testing.assert_close(own.light_distr.cdf, via.light_distr.cdf)


def test_bvh4_table_covers_every_primitive_once():
    fields = soup(tsc, ttf).build_numpy()
    rows, depth = kb.build_bvh4_table(fields["bvh_min"], fields["bvh_max"],
                                      fields["bvh_offset"], fields["bvh_nprims"])
    refs = rows[:, 24:28].view(np.int32)
    counts = rows[:, 28:32].view(np.int32)
    leaf = counts > 0
    covered = np.concatenate([np.arange(r, r + c) for r, c in
                              zip(refs[leaf], counts[leaf])])
    np.testing.assert_array_equal(np.sort(covered),
                                  np.arange(fields["prim_meta"].shape[0]))
    inner = refs[counts == 0]
    np.testing.assert_array_equal(np.sort(inner), np.arange(1, rows.shape[0]))
    assert 1 <= depth and 3 * depth <= kb.STACK_SIZE


def test_refuses_what_is_not_ported():
    b = tsc.SceneBuilder()
    with pytest.raises(NotImplementedError):
        b.add_material(13)  # the BSSRDF adapter, never a table row
    j = jsc.SceneBuilder()
    m = j.add_material(jsc.MAT_BSSRDF_ADAPTER)
    j.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]], material=m)
    with pytest.raises(NotImplementedError):
        bridge.scene_from_numpy(_jax_fields(j.build()), "cpu")
    # a kd-tree, and an area light on a disk (the JAX builder takes one; its
    # reader drops it)
    j = jsc.SceneBuilder()
    j.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    with pytest.raises(NotImplementedError, match="kd_nodes"):
        bridge.scene_from_numpy(_jax_fields(j.build(accelerator="kdtree")), "cpu")
    j = jsc.SceneBuilder()
    li = j.add_area_light_handle((1.0, 1.0, 1.0), jsc.SHAPE_DISK, 0)
    j.add_quadric(jsc.SHAPE_DISK, jtf.identity(), (1.0, 0.0, 0.0, 6.28), -1, li)
    with pytest.raises(NotImplementedError, match="area light shape"):
        bridge.scene_from_numpy(_jax_fields(j.build()), "cpu")


def test_build_on_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = tsc.SceneBuilder()
    b.add_triangle_mesh([[0, 1, 2]], [[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        b.build()
